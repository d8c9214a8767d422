"""Command-line entry points of the port: ``generate`` and ``eval`` (the
counterparts of the same subcommands of the JAX package's ``cli.py``;
``train``, ``infer`` and ``sweep`` are not ported yet).

  python -m pointnet_like_pose_estimation_tpu_torch.cli generate --num-per-class 800
  python -m pointnet_like_pose_estimation_tpu_torch.cli eval --model rotation --data data_cache/dataset.npz

Both run on the card; ``--device cpu`` asks for the CPU. Without a card and
without that option they raise.
"""

from __future__ import annotations

import argparse
import json
import os


def _add_eval_args(p):
    p.add_argument("--model", default="pointnet_cls")
    p.add_argument("--data", default="data_cache/dataset.npz")
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--loss-function", default="L2_loss", choices=["L2_loss", "L1_loss"])
    p.add_argument("--log-dir", default="log")
    p.add_argument("--experiment", default=None)
    p.add_argument("--compat-first3-mean", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _cfg_from_args(args):
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig

    return TrainConfig.for_model(
        args.model,
        batch_size=args.batch_size,
        loss_kind=args.loss_function,
        log_dir=args.log_dir,
        experiment=args.experiment or args.model,
        compat_first3_mean=args.compat_first3_mean,
    )


def cmd_generate(args):
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset

    path = build_dataset(args.num_per_class, seed=args.seed, path=args.out, device=args.device)
    print(f"wrote {path}")


def cmd_eval(args):
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import evaluate, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _ckpt_dir

    cfg = _cfg_from_args(args)
    model = build_model(cfg.model, cfg.num_classes)
    model, meta = load_checkpoint(os.path.join(_ckpt_dir(cfg), "best.msgpack"), model)
    result = evaluate(cfg, model, load_dataset(args.data, "test"), device=args.device)
    result["checkpoint_epoch"] = meta["epoch"]
    print(json.dumps(result))


def main(argv=None):
    p = argparse.ArgumentParser(prog="plpe-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="build the synthetic dataset")
    g.add_argument("--num-per-class", type=int, default=800)
    g.add_argument("--out", default="data_cache/dataset.npz")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("eval", help="evaluate the best checkpoint of an experiment")
    _add_eval_args(e)
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

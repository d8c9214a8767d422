"""Command-line entry points of the port: ``generate``, ``train`` and
``eval`` (the counterparts of the same subcommands of the JAX package's
``cli.py``; ``infer`` and ``sweep`` are not ported yet).

  python -m pointnet_like_pose_estimation_tpu_torch.cli generate --num-per-class 800
  python -m pointnet_like_pose_estimation_tpu_torch.cli train --model pointnet2_cls_ssg --epochs 40
  python -m pointnet_like_pose_estimation_tpu_torch.cli eval --model rotation --data data_cache/dataset.npz

All run on the card; ``--device cpu`` asks for the CPU. Without a card and
without that option they raise. ``train`` takes the JAX command's flags but
``--data-parallel`` and writes ``best.pt`` and ``latest.pt`` under
``<log-dir>/<task>/<experiment>/checkpoints``; ``eval`` reads ``best.pt``
there, or the JAX package's ``best.msgpack`` where the experiment has no
``best.pt``.
"""

from __future__ import annotations

import argparse
import json
import logging


def _add_common_args(p):
    p.add_argument("--model", default="pointnet_cls")
    p.add_argument("--data", default="data_cache/dataset.npz")
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--loss-function", default="L2_loss", choices=["L2_loss", "L1_loss"])
    p.add_argument("--log-dir", default="log")
    p.add_argument("--experiment", default=None)
    p.add_argument("--compat-first3-mean", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _add_train_args(p):
    _add_common_args(p)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--loss-reduction", default="mean", choices=["mean", "sum"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--compat-pm1-bce", action="store_true")


def _cfg_from_args(args):
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig

    kw = dict(
        batch_size=args.batch_size,
        loss_kind=args.loss_function,
        log_dir=args.log_dir,
        experiment=args.experiment or args.model,
        compat_first3_mean=args.compat_first3_mean,
    )
    if args.cmd == "train":
        kw.update(
            epochs=args.epochs,
            optimizer=args.optimizer,
            loss_reduction=args.loss_reduction,
            dtype=args.dtype,
            seed=args.seed,
            augment=not args.no_augment,
            compat_pm1_bce=args.compat_pm1_bce,
        )
        if args.learning_rate is not None:
            kw["learning_rate"] = args.learning_rate
    return TrainConfig.for_model(args.model, **kw)


def cmd_generate(args):
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset

    path = build_dataset(args.num_per_class, seed=args.seed, path=args.out, device=args.device)
    print(f"wrote {path}")


def cmd_train(args):
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import train

    cfg = _cfg_from_args(args)
    _, history = train(cfg, load_dataset(args.data, "train"), load_dataset(args.data, "test"),
                       device=args.device)
    print(json.dumps(history[-1] if history else {}))


def cmd_eval(args):
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import evaluate, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import best_checkpoint

    cfg = _cfg_from_args(args)
    model, meta = load_checkpoint(best_checkpoint(cfg), build_model(cfg.model, cfg.num_classes))
    result = evaluate(cfg, model, load_dataset(args.data, "test"), device=args.device)
    result["checkpoint_epoch"] = meta["epoch"]
    print(json.dumps(result))


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(prog="plpe-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="build the synthetic dataset")
    g.add_argument("--num-per-class", type=int, default=800)
    g.add_argument("--out", default="data_cache/dataset.npz")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    g.set_defaults(fn=cmd_generate)

    t = sub.add_parser("train", help="train one model of the registry")
    _add_train_args(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="evaluate the best checkpoint of an experiment")
    _add_common_args(e)
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

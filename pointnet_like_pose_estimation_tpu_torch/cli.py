"""Command-line entry points of the port: ``generate``, ``train``, ``eval``,
``infer`` and ``sweep`` (the counterparts of the same subcommands of the JAX
package's ``cli.py``).

  python -m pointnet_like_pose_estimation_tpu_torch.cli generate --num-per-class 800
  python -m pointnet_like_pose_estimation_tpu_torch.cli train --model pointnet2_cls_ssg --epochs 40
  python -m pointnet_like_pose_estimation_tpu_torch.cli eval --model rotation --data data_cache/dataset.npz
  python -m pointnet_like_pose_estimation_tpu_torch.cli infer --input scene.ply --checkpoints '{...}'
  python -m pointnet_like_pose_estimation_tpu_torch.cli sweep --epochs 10

All run on the card; ``--device cpu`` asks for the CPU. Without a card and
without that option they raise. ``train`` takes the JAX command's flags and
writes ``best.pt`` and ``latest.pt`` under
``<log-dir>/<task>/<experiment>/checkpoints``; ``eval`` reads ``best.pt``
there, or the JAX package's ``best.msgpack`` where the experiment has no
``best.pt``. ``train --data-parallel`` trains over the ranks that
``torchrun`` starts, one card each:

  torchrun --nproc-per-node 4 -m pointnet_like_pose_estimation_tpu_torch.cli train --data-parallel ...

``train`` and ``eval`` compute in ``--dtype`` (float32 or bfloat16,
BatchNorm in float32 either way). ``infer`` serves raw clouds
(``.ply`` or comma-separated text; several stream through
``GraspPipeline.stream``) with ``--config``, JSON overrides of
``PipelineConfig`` (``dtype`` among them), and ``--checkpoints``, JSON of
the five models' paths (flax ``.msgpack`` or the port's ``.pt``; seeded
random weights without it), and prints one JSON line a cloud. ``sweep``
trains the reference's loss and reduction grid (14 jobs) one after another
and writes ``sweep_results.json`` under ``--log-dir`` after each; a second
call with the same settings resumes where the first stopped.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def _add_common_args(p):
    p.add_argument("--model", default="pointnet_cls")
    p.add_argument("--data", default="data_cache/dataset.npz")
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--loss-function", default="L2_loss", choices=["L2_loss", "L1_loss"])
    p.add_argument("--log-dir", default="log")
    p.add_argument("--experiment", default=None)
    p.add_argument("--compat-first3-mean", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _add_train_args(p):
    _add_common_args(p)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--loss-reduction", default="mean", choices=["mean", "sum"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--compat-pm1-bce", action="store_true")
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel over the ranks torchrun starts (a world of one without it)")


def _cfg_from_args(args):
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig

    kw = dict(
        batch_size=args.batch_size,
        loss_kind=args.loss_function,
        log_dir=args.log_dir,
        experiment=args.experiment or args.model,
        compat_first3_mean=args.compat_first3_mean,
        dtype=args.dtype,
    )
    if args.cmd == "train":
        kw.update(
            epochs=args.epochs,
            optimizer=args.optimizer,
            loss_reduction=args.loss_reduction,
            seed=args.seed,
            augment=not args.no_augment,
            compat_pm1_bce=args.compat_pm1_bce,
            data_parallel=args.data_parallel,
        )
        if args.learning_rate is not None:
            kw["learning_rate"] = args.learning_rate
    return TrainConfig.for_model(args.model, **kw)


def cmd_generate(args):
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset

    path = build_dataset(args.num_per_class, seed=args.seed, path=args.out, device=args.device)
    print(f"wrote {path}")


def cmd_train(args):
    import torch.distributed as dist

    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import train

    cfg = _cfg_from_args(args)
    try:
        _, history = train(cfg, load_dataset(args.data, "train"), load_dataset(args.data, "test"),
                           device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
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


def cmd_infer(args):
    import numpy as np

    from pointnet_like_pose_estimation_tpu_torch.data.io_utils import load_cloud
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    overrides = json.loads(args.config) if args.config else {}
    if "clip_range" in overrides:
        overrides["clip_range"] = tuple(overrides["clip_range"])
    cfg = PipelineConfig(**overrides)
    if args.checkpoints:
        pipe = GraspPipeline.from_checkpoints(cfg, json.loads(args.checkpoints), device=args.device)
    else:
        pipe = GraspPipeline.from_random(cfg, device=args.device)
    clouds = (load_cloud(path).astype(np.float32) for path in args.input)
    for path, out in zip(args.input, pipe.stream(clouds)):
        if out is None:
            print(json.dumps({"input": path, "clusters": 0}))
            continue
        print(json.dumps({
            "input": path,
            "clusters": int(out["clusters"].shape[0]),
            "pred_class": out["pred_class"].tolist(),
            "rotation_deg": out["rotation_deg"].tolist(),
            "translation": out["translation"].tolist(),
            "width": out["width"].tolist(),
        }))


def cmd_sweep(args):
    """Train the reference's grid for ``--epochs`` and record each job's
    last history row in ``<log-dir>/sweep_results.json``: rotation and both
    translation heads at L2/L1 x mean/sum, sign once (its loss is BCE),
    then the PointNet classifier, 14 jobs in that order. The file is
    keyed by job name and stamped with ``_settings`` (epochs and data): a
    second call skips the jobs already there, and refuses a file written
    with other settings or with results but no stamp, since its rows would
    pass for this budget's."""
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, train

    train_ds = load_dataset(args.data, "train")
    test_ds = load_dataset(args.data, "test")
    out_path = os.path.join(args.log_dir, "sweep_results.json")
    settings = {"epochs": args.epochs, "data": args.data}
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        prev = results.get("_settings")
        if prev is None and any(not k.startswith("_") for k in results):
            raise SystemExit(
                f"sweep resume: {out_path} has results but no _settings stamp (unknown budget); "
                f"delete it or pass a different --log-dir to start a fresh sweep")
        if prev is not None and prev != settings:
            raise SystemExit(
                f"sweep resume: {out_path} was produced with settings {prev}, current invocation "
                f"uses {settings}; delete the file or pass a different --log-dir to start a fresh sweep")
    results["_settings"] = settings
    jobs = [(model, kind, reduction)
            for model in ("rotation", "sign", "translation", "translation_no_mlp")
            for kind in ("L2_loss", "L1_loss") for reduction in ("mean", "sum")
            if model != "sign" or (kind, reduction) == ("L2_loss", "mean")]
    jobs.append(("pointnet_cls", "L2_loss", "mean"))
    for model, kind, reduction in jobs:
        name = f"{model}_{kind}_{reduction}"
        if name in results:
            continue
        cfg = TrainConfig.for_model(model, epochs=args.epochs, loss_kind=kind, loss_reduction=reduction,
                                    log_dir=args.log_dir, experiment=name, dtype=args.dtype)
        _, history = train(cfg, train_ds, test_ds, device=args.device)
        results[name] = history[-1]
        print(name, json.dumps(history[-1]))
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)


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

    i = sub.add_parser("infer", help="serve raw clouds through the grasp pipeline")
    i.add_argument("--input", nargs="+", required=True, help=".ply or comma-separated text clouds")
    i.add_argument("--config", default=None, help="JSON overrides of PipelineConfig")
    i.add_argument("--checkpoints", default=None, help="JSON {model key: checkpoint path}")
    i.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    i.set_defaults(fn=cmd_infer)

    s = sub.add_parser("sweep", help="the reference's loss/reduction ablation sweep")
    s.add_argument("--data", default="data_cache/dataset.npz")
    s.add_argument("--epochs", type=int, default=10)
    s.add_argument("--log-dir", default="log")
    s.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.set_defaults(fn=cmd_sweep)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

"""Ranks for the port's parallel tests (``tests/test_torch_parallel_*.py``).

``spawn`` starts ``world`` processes with ``torch.multiprocessing`` (spawn),
joins them into one gloo process group through a ``FileStore`` in a
temporary directory, runs a worker below in each, and returns every rank's
result. A rank that raises fails the test; a run past ``timeout`` is killed
and fails it too. Each rank uses one torch thread, since pytest-xdist runs
several workers on the machine's cores.

The workers import only torch and the port, never JAX: the tests compute
the JAX side in their own process and compare.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, tmp, args, store):
    torch.set_num_threads(1)
    if store:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                                rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(fn, world: int, tmp, *args, store: bool = True, timeout: float = 300.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process; with ``store``, the processes form a gloo group first."""
    tmp = str(tmp)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args, store), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _numpy(t):
    """A copy: a view of a tensor that a later step updates in place would change."""
    return t.detach().cpu().numpy().copy()


def _tensors(batch: dict, dtype=torch.float32) -> dict:
    """Host numpy batch -> tensors: floats in ``dtype``, labels as int64."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}
    out["labels"] = out["labels"].long()
    return out


def _rows(tree, rows):
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return None if tree is None else tree[rows]


def _model(name: str, state_dict: dict, dtype=torch.float64):
    from pointnet_like_pose_estimation_tpu_torch.models import build_model

    model = build_model(name, 7)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dtype)


def _dp_step(mesh, name, state_dict, batch, cfg_kw, draws, dtype=torch.float64):
    """One data-parallel step on this rank's rows: loss, metric, the
    averaged gradients and the state afterwards."""
    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, make_optimizer

    cfg = TrainConfig.for_model(name, **cfg_kw)
    model = P.replicate(_model(name, state_dict, dtype), mesh)
    opt, _ = make_optimizer(cfg, model.parameters())
    rows = P.batch_sharding(mesh, len(batch["points"]))
    step = P.make_parallel_train_step(get_model_spec(name), cfg, mesh)
    out = step(model, opt, _tensors(P.shard_batch(batch, mesh), dtype), draws=_rows(draws, rows))
    return {"loss": float(out["loss"]), "metric": float(out["metric"]),
            "grads": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "state": {k: _numpy(v) for k, v in model.state_dict().items()}}


def dp_worker(rank, world, case):
    """Mesh shapes and ``shard_batch``; the synced BatchNorm; DP steps of
    ``pointnet_cls`` (without draws, and with the single step's draws split
    by rows); ``rotation``, ``sign`` and ``translation`` DP steps on each
    rank's own draws; the collective traffic of a float32 step."""
    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32
    from pointnet_like_pose_estimation_tpu_torch.train import build_state
    from pointnet_like_pose_estimation_tpu_torch.utils.collectives import (
        collective_traffic,
        reset_collective_traffic,
    )

    out = {}
    mesh = P.make_mesh(device_type="cpu")
    mesh22 = P.make_mesh({"data": 2, "points": 2}, device_type="cpu")
    out["mesh"] = {"shape": P.mesh_shape(mesh), "data": mesh.get_local_rank("data"),
                   "rows": P.shard_batch(case["batch"], mesh)["labels"]}
    out["mesh22"] = {"shape": P.mesh_shape(mesh22), "data": mesh22.get_local_rank("data"),
                     "points": mesh22.get_local_rank("points"),
                     "rows": P.shard_batch(case["batch"], mesh22)["labels"]}
    try:
        P.make_mesh({"data": 2 * world}, device_type="cpu")
    except ValueError as e:
        out["too_big"] = str(e)

    x, w, b, cot = (torch.from_numpy(a) for a in case["bn"])
    rows = P.batch_sharding(mesh, len(x))
    bn = BatchNormF32(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xr = x[rows].clone().requires_grad_()
    with P.bn_sync(mesh.get_group("data")):
        y = bn(xr)
    (y * cot[rows]).sum().backward()
    out["bn"] = {"y": _numpy(y), "gx": _numpy(xr.grad), "gw": _numpy(bn.weight.grad),
                 "gb": _numpy(bn.bias.grad), "mean": _numpy(bn.running_mean), "var": _numpy(bn.running_var)}

    out["vs_jax"] = _dp_step(mesh, "pointnet_cls", case["weights"], case["step_batch"],
                             case["cfg"], {"augment": None, "dropout": None})
    out["vs_single"] = _dp_step(mesh, "pointnet_cls", case["weights"], case["step_batch"],
                                {**case["cfg"], "augment": True}, case["draws"])

    out["finite"] = {}
    for name in ("rotation", "sign", "translation"):
        cfg_kw = dict(num_points=32, batch_size=8, augment=True)
        spec, state = build_state(_cfg(name, cfg_kw), device="cpu")
        step = P.make_parallel_train_step(spec, _cfg(name, cfg_kw), mesh)
        got = step(state.model, state.optimizer, _tensors(P.shard_batch(case["small_batch"], mesh)),
                   state.generator)
        out["finite"][name] = (float(got["loss"]), float(got["metric"]))

    spec, state = build_state(_cfg("pointnet_cls", dict(num_points=64, batch_size=8)), device="cpu")
    step = P.make_parallel_train_step(spec, _cfg("pointnet_cls", dict(num_points=64, batch_size=8)), mesh)
    batch = _tensors(P.shard_batch(case["traffic_batch"], mesh))
    reset_collective_traffic()
    step(state.model, state.optimizer, batch, state.generator)
    out["traffic"] = collective_traffic()
    out["n_params"] = sum(p.numel() for p in state.model.parameters())
    return out


def _cfg(name, kw):
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig

    return TrainConfig.for_model(name, **kw)


def train_worker(rank, world, port, log_dir, train_ds, test_ds):
    """``train(data_parallel=True, multihost=True)`` through ``env://``:
    one epoch, then a second call that resumes for another; returns both
    histories, the files this rank wrote, and the epoch's steps."""
    from pointnet_like_pose_estimation_tpu_torch.data import PoseDataset
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig
    from pointnet_like_pose_estimation_tpu_torch.train import loop

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    wrote = []
    save, persist = loop.save_checkpoint, loop._persist_history
    loop.save_checkpoint = lambda path, *a: (wrote.append(os.path.basename(path)), save(path, *a))[1]
    loop._persist_history = lambda path, *a: (wrote.append(os.path.basename(path)), persist(path, *a))[1]
    train_ds, test_ds = PoseDataset(**train_ds), PoseDataset(**test_ds)
    out = {}
    for epochs in (1, 2):
        cfg = TrainConfig.for_model("rotation", num_points=32, batch_size=4, epochs=epochs, log_dir=log_dir,
                                    experiment="dp", data_parallel=True, multihost=True)
        state, history = loop.train(cfg, train_ds, test_ds, device="cpu")
        out[epochs] = history
    out["wrote"] = wrote
    out["world"] = dist.get_world_size()
    out["state"] = {k: _numpy(v) for k, v in state.model.state_dict().items()}
    return out


def sharded_worker(rank, world, case):
    """The sharded ops on ``{"points": world}`` and ``{"data": 2,
    "points": world // 2}`` meshes, and point-sharded forwards of the SSG
    and MSG classifiers."""
    from pointnet_like_pose_estimation_tpu_torch import parallel as P

    out = {}
    meshes = {"points": P.make_mesh({"points": world}, device_type="cpu"),
              "data_points": P.make_mesh({"data": 2, "points": world // 2}, device_type="cpu")}
    for key, mesh in meshes.items():
        batch_axis = "data" if "data" in mesh.mesh_dim_names else None

        def rows(a):
            return a if batch_axis is None else a[P.batch_sharding(mesh, len(a))]

        pts, S = case["fps"]
        out[f"fps/{key}"] = _numpy(P.sharded_farthest_point_sample(
            rows(torch.from_numpy(pts)), S, mesh, batch_axis=batch_axis))
        pts, feats, S, K, r = case["group"]
        cent, grouped = P.sharded_sample_and_group(rows(torch.from_numpy(pts)), rows(torch.from_numpy(feats)),
                                                   S, K, r, mesh, batch_axis=batch_axis)
        out[f"group/{key}"] = (_numpy(cent), _numpy(grouped))
        pts, feats, S, radii, ks = case["multi"]
        cent, grouped = P.sharded_sample_and_group_multi(rows(torch.from_numpy(pts)),
                                                         rows(torch.from_numpy(feats)), S, radii, ks, mesh,
                                                         batch_axis=batch_axis)
        out[f"multi/{key}"] = (_numpy(cent), [_numpy(g) for g in grouped])
    mesh = meshes["points"]
    pts, start, S = case["start"]
    out["start"] = _numpy(P.sharded_farthest_point_sample(torch.from_numpy(pts), S, mesh,
                                                          start_idx=torch.from_numpy(start)))
    pts, S, K, r = case["group_plain"]
    cent, grouped = P.sharded_sample_and_group(torch.from_numpy(pts), None, S, K, r, mesh)
    out["group_plain"] = (_numpy(cent), _numpy(grouped))
    try:
        P.sharded_farthest_point_sample(torch.zeros(1, 4 * world + 1, 3), 2, mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    for name, (weights, pts) in case["forward"].items():
        model = _model(name, weights, torch.float32).eval()
        with torch.no_grad(), P.point_sharding(mesh) as ctx:
            log_probs = model(torch.from_numpy(pts))[0]
        out[f"forward/{name}"] = (_numpy(log_probs), ctx.dispatch_count)
    return out


def tp_worker(rank, world, case):
    """The tensor-parallel rule's specs on a ``{"data": 1, "model":
    world}`` mesh, then two DP x TP steps of ``rotation`` on ``{"data": 2,
    "model": world // 2}`` with the single step's draws split by rows."""
    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import make_optimizer

    out = {}
    spec_mesh = P.make_mesh({"data": 1, "model": world}, device_type="cpu")
    model = _model("rotation", case["weights"], torch.float32)
    out["specs"] = P.tensor_parallel_specs(model, spec_mesh)
    out["count"] = P.count_sharded(model, spec_mesh)

    mesh = P.make_mesh({"data": 2, "model": world // 2}, device_type="cpu")
    model = _model("rotation", case["weights"])
    out["index"] = P.tensor_parallel_shardings(model, mesh)
    P.shard_state_tp(model, mesh)
    cfg = _cfg("rotation", case["cfg"])
    opt, _ = make_optimizer(cfg, model.parameters())
    step = P.make_parallel_train_step(get_model_spec("rotation"), cfg, mesh, tp_axis="model", model=model)
    out["steps"] = []
    for batch, draws in case["steps"]:
        rows = P.batch_sharding(mesh, len(batch["points"]))
        got = step(model, opt, _tensors(P.shard_batch(batch, mesh), torch.float64), draws=_rows(draws, rows))
        out["steps"].append({"loss": float(got["loss"]),
                             "state": {k: _numpy(v) for k, v in model.state_dict().items()},
                             "grads": {k: _numpy(p.grad) for k, p in model.named_parameters()}})
    try:
        P.make_parallel_train_step(get_model_spec("rotation"), cfg, mesh, tp_axis="model",
                                   model=_model("rotation", case["weights"]))
    except ValueError as e:
        out["unsharded"] = str(e)
    return out

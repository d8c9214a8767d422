"""Training epochs: the port's device-resident epoch runner
(``train/steps.py`` ``make_epoch_runner``) driven epoch after epoch over a
resident split, as ``train/loop.py train`` drives it (the StepLR stepped
and the epoch's sums read back after each epoch), without its evaluation
and checkpoints.

Set-up builds the model, Adam and the runner once, and drives that same
object through three one-step calls, the first of which captures the
step's graph: each call's sums give that step's loss, Adam's first moment
after the first gives the gradient the optimizer got, and the parameters
and BatchNorm statistics after the third give each leaf's change. The
window then runs whole epochs on the same object. After the window the
reference works out the same three steps from the same weights and the
same generator state.
"""

from __future__ import annotations

import gc

import torch

from harness import bounds, traffic
from harness.runner import Outcome, clock
from harness.trace import Span
from harness.weights import make_state
from reference import geometry as G
from reference import train as T
from reference.models import build

CHECKED_STEPS = 3
BETA1 = 0.9


class _Stop:
    """The runner's ``stop``: after ``steps`` steps, or at the deadline,
    with a hook at the start of the profiled span."""

    def __init__(self, steps=None, deadline=None, span_at=None, on_span=None):
        self.steps, self.deadline, self.span_at, self.on_span = steps, deadline, span_at, on_span
        self.calls = 0

    def __call__(self) -> bool:
        self.calls += 1
        if self.steps is not None:
            return self.calls > self.steps
        now = clock()
        if self.on_span is not None and now >= self.span_at:
            self.on_span(self.calls - 1)
            self.on_span = None
        return now >= self.deadline


def _setup(run, device):
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig
    from pointnet_like_pose_estimation_tpu_torch.train.state import make_optimizer
    from pointnet_like_pose_estimation_tpu_torch.train.steps import make_epoch_runner

    cfg, mix = run.config, run.mix
    tcfg = TrainConfig(**{**cfg["train"], "batch_size": mix["batch_size"],
                          **({"dtype": run.program_dtype} if run.program_dtype else {})})
    split = traffic.training_split({"per_class": mix["per_class"], "num_points": tcfg.num_points}, run.seed)
    data = {k: torch.from_numpy(v).to(device) for k, v in split.items()}
    weights = make_state(build(tcfg.model, tcfg.num_classes), run.seed % 2**63, device)
    model = build_model(tcfg.model, tcfg.num_classes, tcfg.dtype).to(device)
    model.load_state_dict(weights, strict=True)
    opt, sched = make_optimizer(tcfg, model.parameters())
    steps = len(split["labels"]) // tcfg.batch_size
    runner = make_epoch_runner(get_model_spec(tcfg.model), tcfg, steps)
    gen = torch.Generator(device=device).manual_seed((run.seed * 7919 + 1) % 2**63)
    return tcfg, data, weights, model, opt, sched, steps, runner, gen


def _leaves(model) -> dict:
    """Copies of the parameters and BatchNorm running statistics, by name."""
    return {k: v.detach().clone() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def _checked_steps(model, opt, data, gen, runner, wd: float) -> dict:
    """The three one-step calls: losses, the first gradient, the leaves after."""
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, grads = [], None
    for k in range(CHECKED_STEPS):
        sums, n = runner(model, opt, data, gen, stop=_Stop(steps=1))
        if n != 1:
            raise RuntimeError(f"the epoch runner ran {n} steps where one was asked for")
        losses.append(float(sums[0]))
        if k == 0:
            # Adam's first moment after one step is (1 - beta1) (g + wd p); a
            # step that left no state behind gave the optimizer nothing
            grads = {name: opt.state[p]["exp_avg"] / (1 - BETA1) - wd * p0[name] if "exp_avg" in opt.state[p]
                     else torch.zeros_like(p) for name, p in model.named_parameters()}
    leaves = _leaves(model)
    return {"losses": losses, "grads": grads, "leaves": leaves}


def _reference_steps(weights, data, gen_state, tcfg, steps: int, dtype: str, device) -> dict:
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    tr = T.Trainer(weights, tcfg.num_classes, dtype, tcfg.learning_rate, tcfg.weight_decay, device)
    losses, grads = [], None
    for k in range(CHECKED_STEPS):
        rows, d = next(T.epoch_batches(gen, data, tcfg.batch_size, steps, 1))
        loss, g = tr.step(data["points"][rows], data["labels"][rows], d)
        losses.append(loss)
        if k == 0:
            grads = g
    return {"losses": losses, "grads": grads, "leaves": tr.leaves()}


def _norm(t) -> float:
    return float(t.double().norm())


def compare(got: dict, want: dict, start: dict) -> dict:
    """``loss_gap``: the widest relative gap of the three losses.
    ``grad_gap`` and ``change_gap``: the worst leaf's gap between the two
    sides' norms of the first gradient and of the change after the three
    steps, over the larger of the reference's norm of that leaf and of the
    median leaf. A parameter whose reference gradient is under a thousandth
    of the median leaf's (a bias straight before a BatchNorm, whose true
    gradient is 0) moves by rounding alone and is left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gn = {k: _norm(v) for k, v in want["grads"].items()}
    med = sorted(gn.values())[len(gn) // 2]
    grad = max(abs(_norm(got["grads"][k]) - n) / max(n, med) for k, n in gn.items())
    keep = [k for k in want["leaves"] if k not in gn or gn[k] >= 1e-3 * med]
    dn = {k: _norm(want["leaves"][k] - start[k]) for k in keep}
    dmed = sorted(dn.values())[len(dn) // 2]
    change = max(abs(_norm(got["leaves"][k] - start[k]) - n) / max(n, dmed) for k, n in dn.items())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def _span_bounds(segments, data, tcfg, steps: int, device) -> dict:
    """Least device seconds of the span's FPS and ball-query calls, on the
    span's own batches worked out again from the generator states at the
    start of each runner call (``segments``: state, first and end step)."""
    fps_s = bq_s = 0.0
    B = tcfg.batch_size
    for state, lo, hi in segments:
        gen = torch.Generator(device=device)
        gen.set_state(state)
        for i, (rows, d) in enumerate(T.epoch_batches(gen, data, B, steps, hi)):
            if i < lo:
                continue
            x = T.augment(data["points"][rows], d)
            for S, k, radius, _, _ in bounds.SSG_LEVELS:
                c = G.index_points(x, G.fps(x, S))
                fps_s += bounds.fps_bound_ms(B, x.shape[1], 3, S) / 1e3
                bq_s += bounds.ball_query_bound_ms(x, c, radius, k) / 1e3
                x = c
    return {"fps_bound_s": fps_s, "ball_query_bound_s": bq_s}


def run(run) -> Outcome:
    device = torch.device(run.device)
    mix = run.mix
    tcfg, data, weights, model, opt, sched, steps, runner, gen = _setup(run, device)
    start = _leaves(model)
    gen_state = gen.get_state()
    got = _checked_steps(model, opt, data, gen, runner, tcfg.weight_decay)
    cache = runner.step.cache(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    span = Span(device) if run.trace else None
    run.setup_done()

    B = tcfg.batch_size
    made0 = cache.captures + cache.remade
    pre, segments = {}, []
    done = 0
    t0 = clock()
    deadline = t0 + run.seconds
    while True:
        state = gen.get_state()

        def on_span(step_in_call, state=state):
            pre.update(seconds=clock() - t0, steps=done + step_in_call,
                       captures=cache.captures + cache.remade - made0, at=(state, step_in_call))
            span.start()

        stop = _Stop(deadline=deadline, span_at=deadline - mix["profile_seconds"],
                     on_span=on_span if span is not None and not pre else None)
        sums, n = runner(model, opt, data, gen, stop=stop)
        if pre and span is not None:
            lo = pre["at"][1] if pre["at"][0] is state else 0
            segments.append((state, lo, n))
        done += n
        sched.step()
        sums.tolist()                  # the loop's one read of an epoch's sums
        if clock() >= deadline:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = clock() - t0
    profile = None
    if pre:
        span.stop()
        profile = span.summary()
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    del model, opt, sched, runner, cache
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = {"kind": "train"}
    if pre:
        flops = pre["steps"] * B * bounds.ssg_train_flops_per_cloud(tcfg.num_classes)
        peak_flops = bounds.matmul_peak(tcfg.dtype, torch.backends.cuda.matmul.allow_tf32)
        readings.update(captures=pre["captures"], mfu=bounds.mfu(flops, pre["seconds"], peak_flops),
                        profile=profile, steps_in_span=done - pre["steps"],
                        **_span_bounds(segments, data, tcfg, steps, device))
    want = _reference_steps(weights, data, gen_state, tcfg, steps, run.config["train"]["dtype"], device)
    gaps = compare(got, want, start)
    checks = [(g, gaps[g], run.limits[g]) for g in ("loss_gap", "grad_gap", "change_gap")]
    return Outcome(attempted=done, failed=0, e2e={"train_clouds_per_s": done * B / seconds}, readings=readings,
                   checks=checks, memory_peak_bytes=int(peak), profile=profile)


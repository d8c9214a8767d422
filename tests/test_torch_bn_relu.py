"""The fused BatchNorm + ReLU (``kernels/bn_relu.py``) on the CPU: which
pairs of ``PointwiseMLP`` take it (``nn/layers.py`` ``plain_reason``) and
what the plain path counts, the launch plans the kernels share with the
wrapper, the plain versions of the train-mode passes (the apply pass from
``torch.var_mean``'s statistics, the backward's sums and ``dx``) against
autograd through ``BatchNormF32`` and ``torch.relu`` (the forward bit for
bit, the gradients within rounding), and the plain versions of the eval
passes and ``PointwiseMLP.forward_max`` against ``torch.relu(bn(x))`` and
``.amax(dim=-2)``. The kernels themselves are held against the plain path
on the card in ``tests/test_torch_cuda.py``."""

import copy
import re
from pathlib import Path

import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import bn_relu as fused
from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
    INT32_ELEMENTS,
    MAX_ROW_BLOCKS,
    MIN_PIECE_ROWS,
    POOL_THREADS,
    THREADS,
    bn_relu,
    bn_relu_eval,
    bn_relu_eval_pool,
    bn_relu_plan,
    bn_relu_pool_plan,
    eval_max_reference,
    eval_reference,
    plain_bn_relu,
    plain_bn_relu_eval,
)
from pointnet_like_pose_estimation_tpu_torch.nn import SetAbstraction, layers
from pointnet_like_pose_estimation_tpu_torch.nn.bn_context import bn_sync
from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, PointwiseMLP, plain_reason

CSRC = Path(fused.__file__).resolve().parent / "csrc"
# [R, C] of the SSG classifier's shared MLPs at B = 24 and 256, and shapes
# off the block's rows and column groups
SSG_B24 = [(393_216, 64), (393_216, 128), (196_608, 128), (196_608, 256), (3_072, 256), (3_072, 1024)]
ODD = [(1, 4), (100_003, 64), (777, 12), (5, 2048), (3, 1028)]


class _OtherBatchNorm(BatchNormF32):
    """A BatchNorm with a forward of its own, as the tensor-parallel shard has."""


def _bn(C, dtype=torch.float32, seed=0):
    bn = BatchNormF32(C).to(dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=g, dtype=dtype) + 0.5)
        bn.bias.copy_(torch.rand(C, generator=g, dtype=dtype) - 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=g, dtype=dtype))
        bn.running_var.copy_(torch.rand(C, generator=g, dtype=dtype) + 0.5)
    return bn


def _activations(R, C, dtype, seed=1):
    """Rows as a Linear layer gives them: each channel its own offset and spread."""
    g = torch.Generator().manual_seed(seed)
    offset = 3 * torch.randn(C, generator=g, dtype=dtype)
    spread = torch.rand(C, generator=g, dtype=dtype) * 2 + 0.1
    return torch.randn(R, C, generator=g, dtype=dtype) * spread + offset


@pytest.mark.parametrize(
    "case,reason",
    [("eval", "eval"), ("module", "module"), ("bn_sync", "bn_sync"), ("float64", "dtype"),
     ("bfloat16", "dtype"), ("width", "width"), ("cpu", "device")],
)
def test_plain_reason_names_each_case(case, reason):
    """Each condition of the dispatch rule, checked in its order: on the CPU
    a train-mode float32 pair of a width the kernels take is refused for its
    device alone."""
    C = 6 if case == "width" else 8
    bn = (_OtherBatchNorm if case == "module" else BatchNormF32)(C)
    bn.train(case != "eval")
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(case, torch.float32)
    x = torch.zeros(5, C, dtype=dtype)
    if case == "bn_sync":
        with bn_sync(object()):
            assert plain_reason(x, bn) == reason
    else:
        assert plain_reason(x, bn) == reason


@pytest.mark.parametrize("training,final_activation,pairs", [
    (True, True, 3), (True, False, 2), (False, True, 0), (False, False, 0)])
def test_pointwise_mlp_counts_its_plain_pairs(training, final_activation, pairs):
    """On the CPU every train-mode pair takes the plain path and counts
    there, an eval-mode pair counts nowhere, and the output is
    ``torch.relu(bn(dense(x)))`` layer by layer, bit for bit."""
    torch.manual_seed(0)
    mlp = PointwiseMLP(5, [8, 12, 16], final_activation=final_activation).train(training)
    twin = copy.deepcopy(mlp)
    x = torch.randn(2, 7, 3, 5)
    plain0, fused0 = plain_bn_relu.launches, bn_relu.launches
    got = mlp(x)
    assert (plain_bn_relu.launches - plain0, bn_relu.launches - fused0) == (pairs, 0)
    want = x
    for i in range(3):
        want = getattr(twin, f"dense_{i}")(want)
        if i < 2 or final_activation:
            want = torch.relu(getattr(twin, f"bn_{i}")(want))
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,C", SSG_B24 + [(256 * 512 * 32, 64), (256 * 128 * 64, 256)] + ODD)
def test_bn_relu_plan_covers_the_rows_in_whole_steps(R, C):
    """Every row in exactly one slab, a slab whole steps of ``rpi`` rows, at
    most MAX_ROW_BLOCKS slabs, every column group in one thread of a row."""
    plan = bn_relu_plan(R, C)
    assert plan.tpr * plan.rpi <= THREADS and plan.tpr * plan.chunks >= C // 4 > plan.tpr * (plan.chunks - 1)
    assert plan.slab % plan.rpi == 0 and 1 <= plan.blocks <= MAX_ROW_BLOCKS
    assert (plan.blocks - 1) * plan.slab < R <= plan.blocks * plan.slab
    if R >= plan.rpi * MAX_ROW_BLOCKS:
        assert plan.blocks >= MAX_ROW_BLOCKS // 3     # whole steps a slab cost at most two thirds


@pytest.mark.parametrize("R,C", [(0, 8), (10, 6), (10, 2)])
def test_bn_relu_plan_refuses_what_the_kernels_do_not_take(R, C):
    with pytest.raises(ValueError):
        bn_relu_plan(R, C)


def test_python_mirrors_the_bn_relu_kernel_constants():
    cu = (CSRC / "bn_relu.cu").read_text()
    assert f"constexpr int kThreads = {THREADS};" in cu
    assert "constexpr int kMaxRowBlocks = 4 * 132;" in cu and MAX_ROW_BLOCKS == 4 * 132
    # no kernel of the op may be grouped by the benchmark as a matrix product, FPS or ball query
    names = set(re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", cu))
    assert len(names) == 8 and all(n.startswith("bn_relu_") for n in names)
    assert f"constexpr int kPoolThreads = 512 * 132;" in cu and POOL_THREADS == 512 * 132
    assert f"constexpr int kMinPieceRows = {MIN_PIECE_ROWS};" in cu
    for mark in ("gemm", "Gemm", "cutlass", "addmm", "sm90_xmma", "fps_", "ball_query_kernel"):
        assert not any(mark in n for n in names)


# relative-to-norm tolerance of the gradients, by dtype
GRAD_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


def _rel(got, want) -> float:
    return float((got - want).detach().norm() / want.detach().norm().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("R,C", [(3_000, 64), (1_000, 12), (37, 8), (5, 2048), (2_100, 1024), (1, 4)])
def test_plain_passes_match_autograd_through_batchnorm_and_relu(dtype, R, C):
    """The Function on CPU tensors (its plain passes) against ``torch.relu``
    of ``BatchNormF32`` through autograd: the output, the running statistics
    and ``num_batches_tracked`` equal bit for bit (the same statistics, the
    same roundings), the gradients of x, weight and bias within rounding."""
    bn = _bn(C, dtype)
    twin = copy.deepcopy(bn)
    x = _activations(R, C, dtype).requires_grad_()
    want = torch.relu(bn(x))
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(2), dtype=dtype)
    want_grads = torch.autograd.grad(want, [x, bn.weight, bn.bias], dy)
    x2 = x.detach().clone().requires_grad_()
    got = bn_relu(x2, twin)
    got_grads = torch.autograd.grad(got, [x2, twin.weight, twin.bias], dy)
    assert torch.equal(got, want)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(twin, name), getattr(bn, name)), name
    assert twin.num_batches_tracked == bn.num_batches_tracked == 1
    tol = GRAD_TOL[dtype]
    for name, g, w in zip(("x", "weight", "bias"), got_grads, want_grads):
        if R == 1:      # one row: its normalised value is 0, and so are the gradients of x and weight
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)
        else:
            assert _rel(g, w) <= tol, name


def test_backward_reference_spells_the_sums():
    """``grad_bias`` and ``grad_weight`` are the sums over the rows of the
    ReLU's gradient and of it times the normalised rows, and ``dx`` sums to
    0 over the rows of a channel (a BatchNorm removes any constant)."""
    R, C = 500, 16
    x = _activations(R, C, torch.float64)
    dy = torch.randn(R, C, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    bn = _bn(C, torch.float64)
    var, mean = torch.var_mean(x, dim=0, unbiased=False)
    rstd = torch.rsqrt(var + bn.eps)
    dx, gw, gb = fused.backward_reference(x, dy, mean, rstd, bn.weight.detach(), bn.bias.detach())
    xh = (x - mean) * rstd
    g = dy * (xh * bn.weight.detach() + bn.bias.detach() > 0)
    torch.testing.assert_close(gb, g.sum(0), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gw, (g * xh).sum(0), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dx.sum(0), torch.zeros(C, dtype=torch.float64), rtol=0, atol=1e-10)


@pytest.mark.parametrize("final_activation", [True, False])
def test_pointwise_mlp_through_the_fused_function_equals_the_plain_path(monkeypatch, final_activation):
    """``PointwiseMLP`` with every pair sent to the fused Function (its plain
    passes on the CPU) against the plain path: outputs and the BatchNorms'
    statistics equal bit for bit, every parameter's gradient within
    rounding; no launch is counted on the CPU."""
    torch.manual_seed(1)
    plain = PointwiseMLP(10, [32, 64, 128], final_activation=final_activation).train()
    routed = copy.deepcopy(plain)
    x = torch.randn(4, 16, 24, 10)
    want = plain(x)
    monkeypatch.setattr(layers, "plain_reason", lambda x, bn: None)
    fused0 = bn_relu.launches
    got = routed(x)
    assert bn_relu.launches == fused0
    assert torch.equal(got, want)
    dy = torch.randn(want.shape)
    want.backward(dy)
    got.backward(dy)
    routed_params = dict(routed.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in plain.parameters())
    for name, p in plain.named_parameters():
        torch.testing.assert_close(routed_params[name].grad, p.grad, rtol=1e-4, atol=1e-4 * scale, msg=name)
    routed_state = routed.state_dict()
    for name, v in plain.state_dict().items():
        assert torch.equal(routed_state[name], v), name


# [G, K, C] of the pooled pairs of both serving cells' requests at 32
# clusters (SSG and MSG set abstractions, their global layers, the PointNet
# heads' global max), and shapes off a lane, a block and a piece
POOLED = [(16384, 32, 128), (4096, 64, 256), (32, 128, 1024), (32, 1024, 1024), (16384, 16, 64),
          (16384, 128, 128), (4096, 32, 128), (4096, 128, 256)]
POOLED_ODD = [(1, 1, 4), (5, 3, 12), (33, 1000, 1024), (2, 1280, 64), (7, 9, 2048), (3, 17, 1028)]


@pytest.mark.parametrize("G,K,C", POOLED + POOLED_ODD)
def test_bn_relu_pool_plan_covers_each_group_once(G, K, C):
    """Every row of a group in exactly one piece of at least MIN_PIECE_ROWS
    rows (or the whole group), every piece in one lane of a block, every
    column group in one thread of a lane; a group is cut only where the
    groups alone leave the card short of POOL_THREADS threads, and then
    into enough pieces to fill it, as far as the rows allow."""
    plan = bn_relu_pool_plan(G, K, C)
    assert plan.tpr * plan.rpi <= THREADS and plan.tpr * plan.chunks >= C // 4 > plan.tpr * (plan.chunks - 1)
    assert (plan.pieces - 1) * plan.piece_rows < K <= plan.pieces * plan.piece_rows
    assert plan.pieces == 1 or plan.piece_rows >= MIN_PIECE_ROWS
    assert (plan.blocks - 1) * plan.rpi < G * plan.pieces <= plan.blocks * plan.rpi
    if G * (C // 4) >= POOL_THREADS:
        assert plan.pieces == 1
    else:
        filled = G * plan.pieces * (C // 4) >= POOL_THREADS
        assert filled or plan.piece_rows < 2 * MIN_PIECE_ROWS


@pytest.mark.parametrize("G,K,C", [(0, 4, 8), (4, 0, 8), (4, 4, 6)])
def test_bn_relu_pool_plan_refuses_what_the_kernel_does_not_take(G, K, C):
    with pytest.raises(ValueError):
        bn_relu_pool_plan(G, K, C)


def _eval_bn(C, dtype=torch.float32, seed=0):
    return _bn(C, dtype, seed).eval()


# the plain passes against BatchNormF32's eval forward on the CPU, which
# folds invstd * w into one scale and rounds otherwise: a few ulps of the
# largest term
EVAL_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(3_000, 64), (7, 130, 12), (2, 5, 16, 96), (1, 4), (37, 2048)])
def test_eval_plain_pass_matches_the_plain_pair(dtype, shape):
    """``bn_relu_eval`` on a CPU tensor (its plain version) against
    ``torch.relu(bn(x))`` of an eval-mode ``BatchNormF32``: the same
    values within a few ulps, exactly 0 where the pair gives 0 but for
    rounding at the ReLU's edge, and the shape kept; the BatchNorm's state
    untouched; nothing counted on the CPU."""
    C = shape[-1]
    bn = _eval_bn(C, dtype, seed=C)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    x = _activations(int(torch.tensor(shape[:-1]).prod()), C, dtype, seed=len(shape)).reshape(shape)
    e0 = bn_relu_eval.launches
    with torch.no_grad():
        got, want = bn_relu_eval(x, bn), torch.relu(bn(x))
    assert bn_relu_eval.launches == e0 and got.shape == want.shape and got.dtype == dtype
    scale = float(x.abs().max() * (bn.weight * torch.rsqrt(bn.running_var + bn.eps)).detach().abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=EVAL_TOL[dtype] * scale)
    assert bool((got >= 0).all())
    for k, v in bn.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(64, 16, 64), (2, 40, 32, 128), (3, 1000, 12), (5, 1, 8), (9, 130, 1024)])
def test_eval_plain_pooled_pass_matches_the_plain_pair_and_amax(dtype, shape):
    """``bn_relu_eval_pool`` on a CPU tensor against ``torch.relu(bn(x))
    .amax(dim=-2)``: within a few ulps, and bit for bit the max of the plain
    eval pass (``eval_reference``) over the same rows, ``[..., C]``."""
    C = shape[-1]
    bn = _eval_bn(C, dtype, seed=C + 1)
    x = _activations(int(torch.tensor(shape[:-1]).prod()), C, dtype, seed=C).reshape(shape)
    with torch.no_grad():
        got, want = bn_relu_eval_pool(x, bn), torch.relu(bn(x)).amax(dim=-2)
        assert torch.equal(got, bn_relu_eval(x, bn).amax(dim=-2))
    assert got.shape == want.shape == (*shape[:-2], C)
    scale = float(x.abs().max() * (bn.weight * torch.rsqrt(bn.running_var + bn.eps)).detach().abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=EVAL_TOL[dtype] * scale)


def test_eval_plain_passes_spell_pytorch_s_rounding():
    """The plain eval pass rounds as PyTorch's eval BatchNorm on the card:
    ``w * (x - mean)`` rounded, then ``* invstd + b`` rounded once (a fused
    multiply-add, which two roundings part from), ``invstd = rsqrt(var +
    eps)``; the pooled pass takes the max of that and carries a NaN of its
    group, as ``amax`` does."""
    g = torch.Generator().manual_seed(5)
    C = 16
    rm, rv = torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5
    w, b = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    x = torch.randn(4096, C, generator=g) * 3
    inv = torch.rsqrt(rv + 1e-5)
    p = w * (x - rm)
    fused = ((p.double() * inv.double()) + b.double()).float()
    assert torch.equal(eval_reference(x, rm, rv, w, b, 1e-5), torch.relu(fused))
    assert not torch.equal(torch.relu(fused), torch.relu(p * inv + b))      # the FMA shows
    x3 = x.reshape(256, 16, C).clone()
    x3[3, 5, 2] = float("nan")
    got = eval_max_reference(x3, rm, rv, w, b, 1e-5)
    want = eval_reference(x3.reshape(-1, C), rm, rv, w, b, 1e-5).reshape(256, 16, C).amax(dim=1)
    assert torch.equal(got.isnan(), want.isnan()) and int(got.isnan().sum()) == 1 and bool(got[3, 2].isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert INT32_ELEMENTS == 2**31 - 1
    with torch.no_grad():
        assert plain_reason(torch.empty(INT32_ELEMENTS // C, C, device="meta"), _eval_bn(C)) == "device"


@pytest.mark.parametrize(
    "case,reason",
    [("cpu", "device"), ("bfloat16", "dtype"), ("float64", "dtype"), ("width", "width"), ("bn_sync", "bn_sync"),
     ("module", "module"), ("grad", "eval"), ("input_grad", "eval"), ("size", "size")],
)
def test_plain_reason_in_eval_mode(case, reason):
    """An eval-mode pair takes the eval passes where the train-mode pair's
    conditions other than training hold: on the CPU each case is refused
    for its own reason; one whose output needs a gradient (the BatchNorm's
    parameters or the input under autograd) for the eval passes' lack of a
    backward, and the same pair under ``torch.no_grad`` for its device
    alone; one of 2^31 - 1 elements or more (a tensor without storage here)
    for its size, where PyTorch's eval BatchNorm takes a kernel that rounds
    otherwise."""
    C = 6 if case == "width" else 8
    bn = (_OtherBatchNorm if case == "module" else BatchNormF32)(C).eval()
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(case, torch.float32)
    rows = INT32_ELEMENTS // C + 1 if case == "size" else 5
    x = torch.empty(rows, C, dtype=dtype, device="meta") if case == "size" else torch.zeros(rows, C, dtype=dtype)
    if case == "input_grad":
        bn.requires_grad_(False)
        x.requires_grad_()
    if case == "bn_sync":
        with bn_sync(object()), torch.no_grad():
            assert plain_reason(x, bn) == reason
    elif case in ("grad", "input_grad"):
        assert plain_reason(x, bn) == reason
        with torch.no_grad():
            assert plain_reason(x, bn) == "device"
    else:
        with torch.no_grad():
            assert plain_reason(x, bn) == reason


def _mlp_pair(training, final_activation, seed=2):
    torch.manual_seed(seed)
    mlp = PointwiseMLP(10, [32, 64, 128], final_activation=final_activation).train(training)
    if not training:
        for m in mlp.modules():
            if isinstance(m, BatchNormF32):
                with torch.no_grad():
                    m.running_mean.normal_(0.0, 0.3)
                    m.running_var.uniform_(0.5, 2.0)
    return mlp, copy.deepcopy(mlp)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("final_activation", [True, False])
def test_forward_max_equals_forward_then_amax(training, final_activation):
    """``forward_max`` against ``mlp(x).amax(dim=-2)`` on the CPU, in train
    and eval mode: the output bit for bit, the BatchNorms' state after it
    too; in eval mode the plain eval pairs are counted, one a pair."""
    mlp, twin = _mlp_pair(training, final_activation)
    x = torch.randn(3, 20, 16, 10)
    pairs = 3 if final_activation else 2
    e0 = plain_bn_relu_eval.launches
    with torch.no_grad():
        got = mlp.forward_max(x)
        want = twin(x).amax(dim=-2)
    assert torch.equal(got, want) and got.shape == (3, 20, 128)
    assert plain_bn_relu_eval.launches - e0 == (0 if training else 2 * pairs)
    twin_state = twin.state_dict()
    for k, v in mlp.state_dict().items():
        assert torch.equal(v, twin_state[k]), k


@pytest.mark.parametrize("final_activation", [True, False])
def test_eval_mlp_through_the_eval_passes_takes_the_pooled_pass_last(monkeypatch, final_activation):
    """With every pair sent to the fused passes (their plain versions on
    the CPU), an eval-mode ``PointwiseMLP`` runs its inner pairs through
    ``bn_relu_eval`` and, in ``forward_max``, its last pair through
    ``bn_relu_eval_pool``, which gives the max itself; a last layer without
    BatchNorm keeps the separate max. The values equal the plain pair's
    within a few ulps."""
    mlp, twin = _mlp_pair(False, final_activation)
    x = torch.randn(4, 32, 24, 10)
    with torch.no_grad():
        want = twin(x).amax(dim=-2)
    calls = []
    for name in ("bn_relu_eval", "bn_relu_eval_pool", "plain_bn_relu_eval", "bn_relu", "plain_bn_relu"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda x, bn, fn=fn, name=name: calls.append(name) or fn(x, bn))
    monkeypatch.setattr(layers, "plain_reason", lambda x, bn: None)
    with torch.no_grad():
        got = mlp.forward_max(x)
    if final_activation:
        assert calls == ["bn_relu_eval", "bn_relu_eval", "bn_relu_eval_pool"]
    else:
        assert calls == ["bn_relu_eval", "bn_relu_eval"]
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("routed", [False, True], ids=["plain", "fused"])
def test_train_mode_set_abstraction_calls_what_it_called_before(monkeypatch, routed):
    """A train-mode ``SetAbstraction`` forward through ``forward_max`` runs
    the same functions in the same order as the MLP's forward followed by
    ``.amax(dim=-2)``: its three train-mode pairs (plain on the CPU, or the
    train-mode Function where routed), then one max; no eval pass."""
    calls = []
    for name in ("bn_relu_eval", "bn_relu_eval_pool", "plain_bn_relu_eval", "bn_relu", "plain_bn_relu"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda x, bn, fn=fn, name=name: calls.append(name) or fn(x, bn))
    amax = torch.Tensor.amax
    monkeypatch.setattr(torch.Tensor, "amax", lambda self, *a, **k: calls.append("amax") or amax(self, *a, **k))
    if routed:
        monkeypatch.setattr(layers, "plain_reason", lambda x, bn: None)
    torch.manual_seed(3)
    sa = SetAbstraction(64, 16, 0.4, 3, [16, 16, 32]).train()
    points = torch.rand(2, 256, 3)
    _, feats = sa(points, None)
    pair = "bn_relu" if routed else "plain_bn_relu"
    assert calls == [pair, pair, pair, "amax"] and feats.shape == (2, 64, 32)

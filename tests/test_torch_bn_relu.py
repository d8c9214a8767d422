"""The fused train-mode BatchNorm + ReLU (``kernels/bn_relu.py``) on the
CPU: which pairs of ``PointwiseMLP`` take it (``nn/layers.py``
``plain_reason``) and what the plain path counts, the launch plan the
kernels share with the wrapper, and the plain versions of its passes (the
apply pass from ``torch.var_mean``'s statistics, the backward's sums and
``dx``) against autograd through ``BatchNormF32`` and ``torch.relu``: the
forward bit for bit, the gradients within rounding. The kernels
themselves are held against the plain path on the card in
``tests/test_torch_cuda.py``."""

import copy
import re
from pathlib import Path

import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import bn_relu as fused
from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
    MAX_ROW_BLOCKS,
    THREADS,
    bn_relu,
    bn_relu_plan,
    plain_bn_relu,
)
from pointnet_like_pose_estimation_tpu_torch.nn import layers
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
    assert len(names) == 5 and all(n.startswith("bn_relu_") for n in names)
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

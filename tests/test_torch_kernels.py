"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrapper's checks, bucket independence of a row's result, the
serving engine through the forward kernel, the backward kernel's
determinism, and the autograd Function and a train step through both.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; ``tests/conftest.py`` imports JAX, hence the
``--noconftest`` in the command that runs these on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.serving import programs as tprog
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine

#: kernel vs plain version, (atol, rtol) per compute dtype: the same
#: arithmetic (bf16: the same bf16-rounded operands) summed in another order;
#: see chip_smoke.TOL for the reasoning. Rows at these widths are tens to
#: thousands of nats.
TOL = {None: (2e-3, 1e-5), torch.bfloat16: (1e-2, 1e-5)}

SHAPES = [(1, 1, 8, 16, 12), (3, 7, 8, 16, 130), (17, 3, 37, 70, 131),
          (10, 300, 8, 16, 12), (50, 1, 100, 200, 784),
          (50, 64, 100, 200, 784), (13, 17, 100, 200, 784)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hot-loop kernel has no CPU "
                    "mode (its plain version is tested against JAX in "
                    "test_torch_hot_loop.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(k, b, h1, hid, d, seed=0, device="cuda"):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    return (r(k, b, h1), r(h1, hid, scale=0.2), r(hid, scale=0.1),
            r(hid, hid, scale=0.1), r(hid, scale=0.1), r(hid, d, scale=0.1),
            r(d, scale=0.1),
            (torch.rand((b, d), generator=g) > 0.5).float().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("k,b,h1,hid,d", SHAPES)
def test_kernel_matches_plain_version(cuda, k, b, h1, hid, d, cd):
    args = _inputs(k, b, h1, hid, d)
    thl.reset_launch_counts()
    got = thl.fused_forward(*args, compute_dtype=cd)
    want = thl._reference_impl(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    assert thl.launch_counts()[thl.KERNEL] == 1
    atol, rtol = TOL[cd]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_kernel_row_does_not_depend_on_its_bucket(cuda, cd):
    """Row (kk, b) of a 64-row bucket equals the same row computed in a
    7-row bucket, bitwise: the kernel sums each row in one fixed order."""
    args = _inputs(50, 64, 100, 200, 784, seed=3)
    big = thl.fused_forward(*args, compute_dtype=cd)
    h1, x = args[0], args[7]
    small = thl.fused_forward(h1[:, :7].contiguous(), *args[1:7],
                              x[:7].contiguous(), compute_dtype=cd)
    assert torch.equal(big[:, :7], small)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_kernel_zero_padding_rows_are_finite(cuda, cd):
    """Zero h1 rows and zero pixel rows (the engine's bucket padding) give
    finite sums, equal to the plain version's."""
    args = list(_inputs(50, 3, 100, 200, 784, seed=4))
    args[0] = torch.zeros_like(args[0])
    args[7] = torch.zeros_like(args[7])
    got = thl.fused_forward(*args, compute_dtype=cd)
    assert torch.isfinite(got).all()
    want = thl._reference_impl(*args, compute_dtype=cd)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL[cd][0], rtol=TOL[cd][1])


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = list(_inputs(3, 4, 8, 16, 12))
    with pytest.raises(TypeError, match="float32"):
        thl.fused_forward(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        thl.fused_forward(args[0].transpose(0, 1).contiguous()
                          .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="is on cpu"):
        thl.fused_forward(*args[:7], args[7].cpu())
    with pytest.raises(ValueError, match="shape"):
        thl.fused_forward(*args[:6], args[6][:5], args[7])
    with pytest.raises(ValueError, match="shared memory"):
        big = _inputs(1, 1, 2000, 1000, 12)
        thl.fused_forward(*big)


def _flagship_engine(kernel_path=None, **kw):
    cfg = ModelConfig.two_layer(likelihood="logits", compute_dtype="bfloat16")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    return ServingEngine(params=params, model_config=cfg, k=50,
                         kernel_path=kernel_path, timeout_s=None, **kw)


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(cuda):
    """The flagship engine on the card launches the kernel for score and
    agrees with a reference-pinned engine of the same weights and seeds."""
    eng, ref = _flagship_engine(), _flagship_engine("reference")
    x = (np.random.RandomState(0).rand(19, 784) > 0.5).astype(np.float32)
    thl.reset_launch_counts()
    got = eng.score(x)
    assert thl.launch_counts()[thl.KERNEL] >= 1
    assert {r["path"] for key, r in eng.metrics.snapshot()["kernel"].items()
            if key.startswith("score/")} == {"kernel"}
    thl.reset_launch_counts()
    want = ref.score(x)
    assert thl.launch_counts()[thl.KERNEL] == 0
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 7, 17])
def test_engine_padded_bucket_parity_on_the_card(cuda, n):
    """Engine score over n rows padded to their bucket vs the program on
    exactly those rows. The kernel is bucket-independent, but cuBLAS may
    choose another algorithm for the encoder matmuls at another batch size,
    so on the card this is held to 1e-3 nats rather than bitwise."""
    eng = _flagship_engine(max_batch=32)
    x = (np.random.RandomState(n).rand(n, 784) > 0.5).astype(np.float32)
    got = eng.score(x)
    cfg, _ = eng._kernel_for("score")
    direct = tprog.score_rows(eng._params, cfg, 0, list(range(n)),
                              torch.from_numpy(x).cuda(), 50).cpu().numpy()
    np.testing.assert_allclose(got, direct, atol=1e-3, rtol=0)
    print(f"n={n}: bitwise={np.array_equal(got, direct)} "
          f"max_abs={np.abs(got - direct).max():.3e}")


# --------------------------------------------------------------------------
# the backward kernel (csrc/hot_loop_bwd.cu)
# --------------------------------------------------------------------------

#: backward kernel vs its plain version, per output, relative to the
#: output's largest magnitude. fp32: the same arithmetic summed in another
#: order (weight gradients sum up to R = 5000 rows of both signs). bf16: both
#: round the same operands, but an operand within an fp32 rounding of a
#: bf16 midpoint may round to the neighbouring bf16 value on one side only
#: (2^-8 relative), and its effect spreads through the later products.
BWD_TOL = {None: 1e-4, torch.bfloat16: 1e-2}

BWD_SHAPES = [(1, 1, 8, 16, 12), (13, 17, 8, 16, 130), (3, 5, 37, 70, 130),
              (10, 300, 8, 16, 12), (13, 17, 100, 200, 784),
              (50, 100, 100, 200, 784)]


def _bwd_inputs(k, b, h1, hid, d, seed=0):
    args = list(_inputs(k, b, h1, hid, d, seed=seed))
    g = torch.Generator().manual_seed(seed + 1)
    return args + [torch.randn((k, b), generator=g).cuda()]


def _assert_outputs_close(got, want, rel):
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape, i
        assert torch.isfinite(a).all(), i
        err = float((a - w).abs().max())
        scale = float(w.abs().max())
        assert err <= rel * scale + 1e-6, (i, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("k,b,h1,hid,d", BWD_SHAPES)
def test_bwd_kernel_matches_plain_version(cuda, k, b, h1, hid, d, cd):
    """All seven outputs; 13 x 17 rows leave a ragged last tile and D=130
    a ragged pixel chunk, whose padding must add nothing."""
    args = _bwd_inputs(k, b, h1, hid, d)
    thl.reset_launch_counts()
    got = thl.fused_backward(*args, compute_dtype=cd)
    want = thl._bwd_plain(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    assert thl.launch_counts() == {thl.KERNEL: 0, thl.KERNEL_BWD: 1}
    _assert_outputs_close(got, want, BWD_TOL[cd])


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_bwd_kernel_is_bitwise_deterministic(cuda, cd):
    """No float atomics: two launches on the same inputs agree bitwise,
    weight gradients included (fixed row groups, fixed-order sum)."""
    args = _bwd_inputs(50, 100, 100, 200, 784, seed=5)
    first = thl.fused_backward(*args, compute_dtype=cd)
    second = thl.fused_backward(*args, compute_dtype=cd)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_fused_block_ll_gradients_on_the_card(cuda, cd):
    """The autograd Function on CUDA tensors (B1 forward, B2 backward):
    h1 and every weight and bias get torch.autograd's gradient through the
    plain forward, within the tolerance of tests/test_torch_hot_loop_bwd.py
    (the autodiff of the plain forward rounds at other points in bf16)."""
    args = _bwd_inputs(13, 17, 100, 200, 784, seed=6)
    x, g = args[7], args[8]
    leaves = [a.clone().requires_grad_(True) for a in args[:7]]
    thl.reset_launch_counts()
    got = torch.autograd.grad(thl.FusedBlockLL.apply(*leaves, x, cd), leaves,
                              g)
    assert thl.launch_counts() == {thl.KERNEL: 1, thl.KERNEL_BWD: 1}
    ref = [a.clone().requires_grad_(True) for a in args[:7]]
    want = torch.autograd.grad(thl._reference_impl(*ref, x, cd), ref, g)
    _assert_outputs_close(got, want, 1e-4 if cd is None else 2e-2)


@pytest.mark.cuda
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _bwd_inputs(3, 4, 8, 16, 12)
    with pytest.raises(ValueError, match="shape"):
        thl.fused_backward(*args[:8], args[8][:, :3].contiguous())
    with pytest.raises(ValueError, match="is on cpu"):
        thl.fused_backward(*args[:8], args[8].cpu())
    with pytest.raises(ValueError, match="shared memory"):
        big = _bwd_inputs(1, 1, 2000, 1000, 12)
        thl.fused_backward(*big)


@pytest.mark.cuda
def test_train_step_launches_both_kernels(cuda):
    """One flagship-width IWAE step on the card runs B1 once and B2 once;
    a DReG step runs B2 twice."""
    from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
    from iwae_replication_project_tpu_torch.training import train_step as ts

    cfg = ModelConfig.two_layer(likelihood="logits", compute_dtype="bfloat16",
                                fused_likelihood=True)
    x = (torch.rand((100, 784), generator=torch.Generator().manual_seed(0))
         > 0.5).float().cuda()
    for name, bwd in (("IWAE", 1), ("DReG", 2)):
        state = ts.create_train_state(0, cfg, device="cuda")
        step = ts.make_train_step(ObjectiveSpec(name=name, k=50), cfg)
        thl.reset_launch_counts()
        state, metrics = step(state, x)
        torch.cuda.synchronize()
        assert thl.launch_counts() == {thl.KERNEL: 1, thl.KERNEL_BWD: bwd}
        assert torch.isfinite(metrics["loss"])

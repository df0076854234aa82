"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrapper's checks, bucket independence of a row's result, the
serving engine through the forward kernel, the backward kernel's
determinism, and the autograd Function and a train step through both; then
the fused Bernoulli log-likelihood's forward and backward kernels the same
way.

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
from iwae_replication_project_tpu_torch.ops import row_invariant as tri
from iwae_replication_project_tpu_torch.serving import programs as tprog
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine

#: kernel vs plain version, (atol, rtol) per compute dtype: the same
#: arithmetic (bf16: the same bf16-rounded operands) summed in another order;
#: see chip_smoke.TOL for the reasoning. Rows at these widths are tens to
#: thousands of nats.
TOL = {None: (2e-3, 1e-5), torch.bfloat16: (1e-2, 1e-5)}

SHAPES = [(1, 1, 8, 16, 12), (3, 7, 8, 16, 130), (17, 3, 37, 70, 131),
          (3, 5, 37, 70, 130), (10, 300, 8, 16, 12), (50, 1, 100, 200, 784),
          (50, 64, 100, 200, 784), (13, 17, 100, 200, 784),
          (250, 500, 100, 200, 784)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested against JAX in "
                    "test_torch_hot_loop*.py and "
                    "test_torch_fused_likelihood.py)")
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
    # the bf16 tile keeps two activation buffers and the weight ring on
    # chip: at 64 rows a CTA with 336 hidden units is past 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        thl.fused_forward(*_inputs(1, 1, 100, 336, 12),
                          compute_dtype=torch.bfloat16)
    # 256 fit shared memory, but a layer's A fragments sit in registers,
    # which hold reductions up to 240: the kernel refuses the launch
    with pytest.raises(RuntimeError, match="CUDA error"):
        thl.fused_forward(*_inputs(1, 1, 100, 256, 12),
                          compute_dtype=torch.bfloat16)


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
    """Engine score over n rows padded to their bucket (a graph replayed
    from the executable store) vs the eager program on exactly those rows:
    bitwise, as the JAX programs promise. The serving programs run the
    row-invariant dense layers and sums on the card (ops/row_invariant), so
    neither the bucket nor the padding changes a row's bits."""
    eng = _flagship_engine(max_batch=32)
    x = (np.random.RandomState(n).rand(n, 784) > 0.5).astype(np.float32)
    got = eng.score(x)
    cfg, _ = eng._kernel_for("score")
    assert cfg.row_invariant
    direct = tprog.score_rows(eng._params, cfg, 0, list(range(n)),
                              torch.from_numpy(x).cuda(), 50).cpu().numpy()
    assert np.array_equal(got, direct), np.abs(got - direct).max()


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
              (13, 17, 100, 200, 130), (50, 100, 100, 200, 784)]


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
@pytest.mark.parametrize("k,b,d", [(50, 100, 784), (13, 17, 130)])
def test_bwd_kernel_is_bitwise_deterministic(cuda, k, b, d, cd):
    """No float atomics: two launches on the same inputs agree bitwise,
    weight gradients included (fixed row groups or splits, fixed-order
    sums)."""
    args = _bwd_inputs(k, b, 100, 200, d, seed=5)
    first = thl.fused_backward(*args, compute_dtype=cd)
    second = thl.fused_backward(*args, compute_dtype=cd)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_bwd_padding_adds_exactly_zero(cuda, cd):
    """Padding rows and pixels add exactly zero to dW and db. Rows: 221 rows
    (a ragged last tile) give bitwise the gradients of 224 rows whose last
    three have a zero cotangent, with the same tiles and splits. Pixels:
    D = 130 gives bitwise the gradients of D = 136 whose six extra pixels
    have zero weights, x = 1 and a bias of 100, so sigmoid(l) = 1 = x and
    their dl is exactly 0."""
    h1, w1, b1, w2, b2, w3, b3, x, g = _bwd_inputs(1, 224, 100, 200, 130,
                                                   seed=8)
    g = g.clone()
    g[:, 221:] = 0.0
    full = thl.fused_backward(h1, w1, b1, w2, b2, w3, b3, x, g,
                              compute_dtype=cd)
    cut = thl.fused_backward(h1[:, :221].contiguous(), w1, b1, w2, b2, w3, b3,
                             x[:221].contiguous(), g[:, :221].contiguous(),
                             compute_dtype=cd)
    assert torch.equal(full[0][:, :221], cut[0])
    assert all(torch.equal(a, c) for a, c in zip(full[1:], cut[1:]))

    wide_w3 = torch.cat([w3, torch.zeros_like(w3[:, :6])], dim=1)
    wide_b3 = torch.cat([b3, torch.full_like(b3[:6], 100.0)])
    wide_x = torch.cat([x, torch.ones_like(x[:, :6])], dim=1)
    wide = thl.fused_backward(h1, w1, b1, w2, b2, wide_w3.contiguous(),
                              wide_b3, wide_x.contiguous(), g,
                              compute_dtype=cd)
    for a, c in zip(wide[:5], full[:5]):
        assert torch.equal(a, c)
    assert torch.equal(wide[5][:, :130], full[5])
    assert torch.equal(wide[6][:130], full[6])
    assert not wide[5][:, 130:].any() and not wide[6][130:].any()


@pytest.mark.cuda
def test_scratch_sizes_at_the_train_shape(cuda):
    """The scratch the libraries ask for at the flagship's train shape
    (k=50 x B=100, H1=100, hidden=200, D=784). B1 bf16: the prepared
    weights, 4 + 4 + 13 tiles of [112 or 208][72] bf16; fp32 none. B2 bf16:
    the prepared weights, bf16 operand rows, bias groups and 5 row splits of
    the 217,984 gradient floats; fp32: 128 row groups of them."""
    from iwae_replication_project_tpu_torch.ops import _kernels
    fwd, bwd = _kernels.load(thl.KERNEL), _kernels.load(thl.KERNEL_BWD)
    assert fwd.hot_loop_fwd_scratch_bytes(100, 200, 784, 1) == \
        2 * 72 * (4 * 112 + 4 * 208 + 13 * 208)
    assert fwd.hot_loop_fwd_scratch_bytes(100, 200, 784, 0) == 0
    assert bwd.hot_loop_bwd_scratch_bytes(5000, 100, 200, 784, 1) == 26765056
    assert bwd.hot_loop_bwd_scratch_bytes(5000, 100, 200, 784, 0) == \
        128 * 217984 * 4


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
    with pytest.raises(ValueError, match="shared memory"):
        thl.fused_backward(*_bwd_inputs(1, 1, 100, 256, 12),
                           compute_dtype=torch.bfloat16)


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


# --------------------------------------------------------------------------
# the fused Bernoulli log-likelihood (csrc/fused_ll_fwd.cu, fused_ll_bwd.cu)
# --------------------------------------------------------------------------

#: B3/B4 vs their plain versions, fp32: the kernels' 3xTF32 products carry
#: ~2^-22 relative error per product (tests/test_torch_tf32_split.py), below
#: the fp32 rounding of the sums, which run in another order (H = 200
#: products per logit, 784 pixel terms per row; dW sums up to R = 125000
#: rows of both signs). Forward: (atol, rtol) as B1's; backward: relative to
#: each output's largest magnitude, as B2's.
FLL_TOL = (2e-3, 1e-5)
FLL_BWD_TOL = 1e-4

#: odd k and B leave a ragged last CTA; D = 130 a ragged pixel tile; H = 13
#: a hidden width that is not a multiple of the MMA's k of 8 (and h rows
#: that are not 16-byte aligned for the weight-gradient phase's copies);
#: k = B = 1 a single row; 41 x 25 = 1025 rows, just past the first row
#: split boundary of B4's weight-gradient phase (1024 rows: one split, 1025:
#: two)
FLL_SHAPES = [(5, 6, 16, 12), (13, 17, 16, 130), (3, 4, 8, 1024),
              (17, 7, 16, 130), (13, 17, 200, 130), (50, 100, 200, 784),
              (5, 6, 13, 130), (1, 1, 200, 784), (41, 25, 200, 784)]


def _fll_inputs(k, b, h, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn((k, b, h), generator=g)).cuda(),
            (torch.randn((h, d), generator=g) * 0.1).cuda(),
            (torch.randn((d,), generator=g) * 0.1).cuda(),
            (torch.rand((b, d), generator=g) > 0.5).float().cuda(),
            torch.randn((k, b), generator=g).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,h,d", FLL_SHAPES)
def test_fused_ll_kernels_match_plain_versions(cuda, k, b, h, d):
    """B3 and B4 against their plain versions, with one launch each; odd k
    and B leave a ragged last row tile, D = 130 a ragged pixel chunk."""
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    h1, w, bias, x, g = _fll_inputs(k, b, h, d)
    tfl.reset_launch_counts()
    got = tfl.fused_ll_forward(h1, w, bias, x)
    grads = tfl.fused_ll_backward(h1, w, bias, x, g)
    torch.cuda.synchronize()
    assert tfl.launch_counts() == {tfl.KERNEL_FWD: 1, tfl.KERNEL_BWD: 1}
    np.testing.assert_allclose(got.cpu().numpy(),
                               tfl._reference_impl(h1, w, bias, x)
                               .cpu().numpy(), atol=FLL_TOL[0],
                               rtol=FLL_TOL[1])
    _assert_outputs_close(grads, tfl._bwd_plain(h1, w, bias, x, g),
                          FLL_BWD_TOL)


@pytest.mark.cuda
def test_fused_ll_scratch_at_the_train_shape(cuda):
    """The scratch B3 and B4 take at the flagship's train shape (R = 5000,
    H = 200, D = 784), as their libraries state it and the wrappers
    allocate it. B3: the prepared weights, 13 tiles of [200][72] fp32. B4:
    those, the fp32 dl rows [5000][784], one db slot of 784 floats per
    16-row group (313) and 5 row splits of H D + D floats, each part
    256-byte aligned: under 30 MB."""
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    fwd, bwd = _kernels.load(tfl.KERNEL_FWD), _kernels.load(tfl.KERNEL_BWD)

    def align(v):
        return (v + 255) // 256 * 256

    prep = 13 * 200 * 72 * 4
    o_db = align(prep + 5000 * 784 * 4)
    o_slots = align(o_db + 313 * 784 * 4)
    want = align(o_slots + 5 * (200 * 784 + 784) * 4)
    assert fwd.fused_ll_fwd_scratch_bytes(200, 784) == prep
    assert bwd.fused_ll_bwd_splits(5000) == 5
    assert bwd.fused_ll_bwd_scratch_bytes(5000, 200, 784) == want == 20562432
    assert want <= 30e6
    assert _kernels.plan(tfl.KERNEL_BWD, (200,), (5000, 200, 784))[1] == want
    assert _kernels.plan(tfl.KERNEL_FWD, (200,), (200, 784))[1] == prep


@pytest.mark.cuda
def test_fused_ll_bwd_is_bitwise_deterministic(cuda):
    """No float atomics: two launches give bitwise equal dh, dW and db."""
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    args = _fll_inputs(50, 100, 200, 784, seed=2)
    first = tfl.fused_ll_backward(*args)
    second = tfl.fused_ll_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_fused_ll_row_does_not_depend_on_its_batch(cuda):
    """Row (kk, b) of a 100-row batch equals the same row in a 7-row batch,
    bitwise: each row's pixel sum runs in one fixed order."""
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    h1, w, bias, x, _ = _fll_inputs(50, 100, 200, 784, seed=3)
    big = tfl.fused_ll_forward(h1, w, bias, x)
    small = tfl.fused_ll_forward(h1[:, :7].contiguous(), w, bias,
                                 x[:7].contiguous())
    assert torch.equal(big[:, :7], small)


@pytest.mark.cuda
def test_fused_bernoulli_ll_on_the_card(cuda):
    """The op's autograd Function on CUDA tensors runs B3 forward and B4
    backward and gives the plain gradients; x gets none."""
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    h1, w, bias, x, g = _fll_inputs(13, 17, 200, 784, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (h1, w, bias)]
    tfl.reset_launch_counts()
    got = torch.autograd.grad(tfl.fused_bernoulli_ll(*leaves, x), leaves, g)
    assert tfl.launch_counts() == {tfl.KERNEL_FWD: 1, tfl.KERNEL_BWD: 1}
    ref = [t.clone().requires_grad_(True) for t in (h1, w, bias)]
    want = torch.autograd.grad(tfl._reference_impl(*ref, x), ref, g)
    _assert_outputs_close(got, want, FLL_BWD_TOL)


@pytest.mark.cuda
def test_fused_ll_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
    h1, w, bias, x, g = _fll_inputs(3, 4, 8, 12)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="float32"):
            tfl.fused_ll_forward(h1.to(dtype), w, bias, x)
        with pytest.raises(TypeError, match="float32"):
            tfl.fused_ll_backward(h1, w.to(dtype), bias, x, g)
    with pytest.raises(ValueError, match="is on cpu"):
        tfl.fused_ll_forward(h1, w, bias, x.cpu())
    with pytest.raises(ValueError, match="shape"):
        tfl.fused_ll_backward(h1, w, bias, x, g[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tfl.fused_ll_forward(h1, w.t().contiguous().t(), bias, x)
    big = _fll_inputs(1, 1, 2000, 12)
    with pytest.raises(ValueError, match="shared memory"):
        tfl.fused_ll_forward(*big[:4])
    with pytest.raises(ValueError, match="shared memory"):
        tfl.fused_ll_backward(*big)


# --------------------------------------------------------------------------
# the row-invariant kernels of the serving programs (csrc/row_dense.cu,
# csrc/row_sum.cu)
# --------------------------------------------------------------------------

#: (M, K, N): the flagship's serving layers (encoder at the bucket and at
#: k x bucket rows, the decoder blocks, the output block of decode) and
#: ragged ones
DENSE_SHAPES = [(1, 784, 200), (64, 784, 200), (3200, 100, 100),
                (3200, 200, 100), (64, 200, 784), (7, 37, 130),
                (129, 16, 65), (1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_row_dense_matches_plain_version(cuda, m, k, n, tanh, cd):
    """The kernel against ``models.mlp.dense_apply``'s ops on the same
    operands: the same (bf16-rounded) products summed in another order.
    K <= 784 terms whose absolute sum is ~20 at these scales: an fp32
    reordering moves the sum by ~sqrt(K) 2^-24 20 ~ 3e-5, so 2e-4
    absolute."""
    g = torch.Generator().manual_seed(m * 7 + k)
    x = torch.randn((m, k), generator=g).cuda()
    w = (torch.randn((k, n), generator=g) * k ** -0.5).cuda()
    b = (torch.randn((n,), generator=g) * 0.1).cuda()
    tri.reset_launch_counts()
    got = tri.dense(x, w, b, cd, tanh)
    want = tri.dense_plain(x, w, b, cd, tanh)
    torch.cuda.synchronize()
    assert tri.launch_counts()[tri.KERNEL_DENSE] == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_row_dense_row_does_not_depend_on_its_batch(cuda, cd):
    """A row's outputs are the same bits at every row count and position."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((200, 784), generator=g).cuda()
    w = (torch.randn((784, 200), generator=g) * 0.03).cuda()
    b = torch.randn((200,), generator=g).cuda()
    alone = tri.dense(x[5:6], w, b, cd, True)
    for m in (2, 7, 64, 65, 200):
        lo = min(5, m - 1)
        part = tri.dense(x[5 - lo:5 - lo + m].contiguous(), w, b, cd, True)
        assert torch.equal(part[lo], alone[0]), m


#: (M, K, N) grid of the tile-invariance test: M crosses every tile of the
#: plan (tests/test_torch_row_invariant.py pins which); K covers the ragged
#: widths (37, 50: 4-byte loads, a partial k16 step) and a multi-slab one
INVARIANCE_M = (1, 2, 7, 16, 17, 64, 65, 200, 3200)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("k", [37, 50, 100, 784, 2000])
@pytest.mark.parametrize("n", [50, 100, 200, 784])
def test_row_dense_row_bits_do_not_depend_on_the_tile(cuda, n, k, tanh, cd):
    """A row's outputs are the same bits at every M of
    :data:`INVARIANCE_M`, on whatever tile the plan picks for that M, and at
    another place in its tile (slices starting at row 0 and at row 5)."""
    g = torch.Generator().manual_seed(n * 1000 + k)
    x = torch.randn((3205, k), generator=g).cuda()
    w = (torch.randn((k, n), generator=g) * k ** -0.5).cuda()
    b = (torch.randn((n,), generator=g) * 0.1).cuda()
    full = tri.dense(x, w, b, cd, tanh)
    tiles = set()
    for m in INVARIANCE_M:
        tiles.add(tri.dense_plan(m, n))
        for lo in (0, 5):
            part = tri.dense(x[lo:lo + m].contiguous(), w, b, cd, tanh)
            assert torch.equal(part, full[lo:lo + m]), (m, lo)
    assert len(tiles) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 784, 200), (64, 200, 784),
                                   (3200, 100, 100), (3200, 100, 50),
                                   (3200, 784, 784), (1, 784, 200),
                                   (7, 2000, 3)])
def test_row_dense_launches_the_planned_ctas(cuda, m, k, n, bf16):
    """The library's grid is the plan's (tiles times parts of K): 28 tiles
    at 64 x 200 (the encoder's first layer at a full bucket), its K = 784
    in 4 parts in bf16."""
    assert tri.kernel_ctas(m, n, k, bf16) == tri.dense_ctas(m, n, k, bf16)
    if (m, k, n) == (64, 784, 200):
        assert tri.dense_ctas(m, n, k, bf16) == (112 if bf16 else 28)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((3200, 100), -1), ((50, 64, 100), -1),
                                       ((64, 784), -1), ((1, 1, 784), -1),
                                       ((33, 257), -1), ((50, 64), 0),
                                       ((50, 64, 50), 0), ((250, 8), 0),
                                       ((7, 33, 5), 1), ((3, 300, 70), 1)])
def test_row_sum_is_bitwise_the_in_order_sum(cuda, shape, dim):
    """The kernel bitwise equal to ``sum_in_order`` (an fp32 accumulator
    adding ``x.select(dim, r)`` for r in order), over the last axis (rows
    staged with 16-byte and 4-byte loads, R over one chunk) and over an
    outer axis; from a misaligned start too."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).cuda()
    assert torch.equal(tri.fixed_sum(x, dim), tri.sum_in_order(x, dim))
    flat = torch.randn((x.numel() + 1,), generator=g).cuda()
    xs = flat[1:].view(shape)
    assert torch.equal(tri.fixed_sum(xs, dim), tri.sum_in_order(xs, dim))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((50, 64, 100), -1), ((50, 64), 0),
                                       ((50, 3, 50), 0), ((1, 1, 784), -1),
                                       ((7, 33, 5), 1), ((250, 8), 0)])
def test_row_sum_matches_torch_sum(cuda, shape, dim):
    """The fixed-order sum against torch.sum: the same fp32 terms added in
    another order, at most 784 terms of magnitude ~1."""
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).cuda()
    tri.reset_launch_counts()
    got = tri.fixed_sum(x, dim)
    want = torch.sum(x, dim=dim)
    torch.cuda.synchronize()
    assert tri.launch_counts()[tri.KERNEL_SUM] == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-6)


@pytest.mark.cuda
def test_row_sum_column_does_not_depend_on_the_batch(cuda):
    """The sum over k of a [k, B] block: column 0's bits are the same in
    every B, and a last-axis row sum's the same in every row count."""
    g = torch.Generator().manual_seed(9)
    lw = torch.randn((50, 64), generator=g).cuda()
    col = tri.fixed_sum(lw[:, :1].contiguous(), 0)
    for b in (2, 3, 17, 64):
        assert torch.equal(tri.fixed_sum(lw[:, :b].contiguous(), 0)[0],
                           col[0])
    rows = torch.randn((64, 100), generator=g).cuda()
    one = tri.fixed_sum(rows[:1], -1)
    assert torch.equal(tri.fixed_sum(rows, -1)[0], one[0])


@pytest.mark.cuda
def test_row_invariant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 8), device="cuda")
    w = torch.randn((8, 3), device="cuda")
    b = torch.randn((3,), device="cuda")
    with pytest.raises(ValueError, match="shape"):
        tri.dense(x, w[:7], b)
    with pytest.raises(TypeError, match="float32"):
        tri.dense(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        tri.fixed_sum(x.t(), 0)
    with pytest.raises(RuntimeError, match="no backward"):
        tri.dense(x, w.requires_grad_(), b)


# --------------------------------------------------------------------------
# the int8 serving policy's layer (csrc/row_dense.cu, int8-weight mode) and
# B1's row groups (csrc/hot_loop_fwd.cu, the tile ops/autotune.py tunes)
# --------------------------------------------------------------------------

#: (M, K, N, tanh): the flagship's int8 output block at M = k x bucket
#: (k = 50, buckets 64 and 1) and ragged shapes (4-byte and byte loads of
#: the weights, a partial k16 step, one element)
INT8_SHAPES = [(3200, 100, 200, True), (3200, 200, 200, True),
               (3200, 200, 784, False), (50, 100, 200, True),
               (50, 200, 784, False), (7, 37, 130, True),
               (129, 16, 65, False), (1, 1, 1, True)]


def _int8_layer(m, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g) * k ** -0.5
    b = torch.randn((n,), generator=g) * 0.1
    q = thl.quantize_out_block({name: {"w": w, "b": b}
                                for name in ("l1", "l2", "out")})["out"]
    return x.cuda(), q["w_q"].cuda(), q["scale"].cuda(), q["b"].cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,tanh", INT8_SHAPES)
def test_row_dense_int8_matches_plain_version(cuda, m, k, n, tanh):
    """The int8 mode against ``dense_int8_plain`` on the card: the same
    products (an int8 weight is exact in fp32) summed in another order,
    then the same rounded scale and bias. With the scale the layer is the
    fp32 test's layer to within the quantization, so the same 2e-4
    absolute bound holds (~sqrt(K) 2^-24 times a sum of ~20)."""
    x, w_q, scale, b = _int8_layer(m, k, n, seed=m * 7 + k)
    tri.reset_launch_counts()
    got = tri.dense_int8(x, w_q, scale, b, tanh)
    want = tri.dense_int8_plain(x, w_q, scale, b, tanh)
    torch.cuda.synchronize()
    counts = tri.launch_counts()
    assert counts[tri.KERNEL_DENSE_INT8] == 1 and counts[tri.KERNEL_DENSE] == 0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,tanh", [(100, 200, True), (200, 200, True),
                                      (200, 784, False), (37, 50, True)])
def test_row_dense_int8_row_bits_do_not_depend_on_m_or_tile(cuda, k, n,
                                                            tanh):
    """C6 for int8: a row's outputs are the same bits at every M of
    :data:`INVARIANCE_M` (1..3200, every tile of the plan) and at another
    place in its tile."""
    x, w_q, scale, b = _int8_layer(3205, k, n, seed=n * 1000 + k)
    full = tri.dense_int8(x, w_q, scale, b, tanh)
    tiles = set()
    for m in INVARIANCE_M:
        tiles.add(tri.dense_plan(m, n))
        for lo in (0, 5):
            part = tri.dense_int8(x[lo:lo + m].contiguous(), w_q, scale, b,
                                  tanh)
            assert torch.equal(part, full[lo:lo + m]), (m, lo)
    assert len(tiles) >= 2


@pytest.mark.cuda
def test_row_dense_int8_rejects_what_the_kernel_does_not_take(cuda):
    x, w_q, scale, b = _int8_layer(4, 8, 3, seed=0)
    with pytest.raises(ValueError, match="int8"):
        tri.dense_int8(x, w_q.float(), scale, b)
    with pytest.raises(ValueError, match="shape"):
        tri.dense_int8(x, w_q, scale[:2], b)
    with pytest.raises(RuntimeError, match="no backward"):
        tri.dense_int8(x.requires_grad_(), w_q, scale, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", [(50, 1), (50, 64), (50, 100), (250, 500)])
def test_hot_loop_fwd_groups_are_bitwise_the_rule(cuda, k, b):
    """B1 in bf16 at 1..4 row groups per CTA gives the bits of ``groups=0``
    (the kernel's own rule) at the serve, train and eval shapes: a group
    computes its rows alone, so the tile the autotuner picks changes
    speed, never a result."""
    args = _inputs(k, b, 100, 200, 784, seed=k + b)
    thl.reset_launch_counts()
    ref = thl.fused_forward(*args, compute_dtype=torch.bfloat16)
    for groups in (1, 2, 3, 4):
        got = thl.fused_forward(*args, compute_dtype=torch.bfloat16,
                                groups=groups)
        assert torch.equal(got, ref), groups
    torch.cuda.synchronize()
    assert thl.launch_counts()[thl.KERNEL] == 5
    with pytest.raises(ValueError, match="groups"):
        thl.fused_forward(*args, compute_dtype=torch.bfloat16, groups=5)
    with pytest.raises(ValueError, match="no row groups"):
        thl.fused_forward(*args, groups=2)

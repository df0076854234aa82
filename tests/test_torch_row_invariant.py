"""The row-invariant ops' host side on the CPU (``ops/row_invariant``): the
output-tile plan of ``csrc/row_dense.cu`` at every dense layer the
flagship serves, the in-order sum that ``csrc/row_sum.cu`` is held to, and
the CPU wrappers' plain versions. The kernels themselves run only on the
card (``tests/test_torch_kernels.py``, marker ``cuda``).
"""

import dataclasses
import inspect
import math

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.ops import row_invariant as ri
from iwae_replication_project_tpu_torch.serving import programs

PRESET = "northstar-iwae-2l-k50"
BUCKETS = (1, 2, 3, 7, 8, 16, 33, 64)


def _smallest_tile_ctas(m, n):
    bm, bn = ri.DENSE_TILES[-1]
    return math.ceil(m / bm) * math.ceil(n / bn)


@pytest.fixture(scope="module")
def served_shapes():
    """{(op, bucket): [(M, K, N), ...]} of every dense layer the flagship's
    programs run at k=50 with the row-invariant ops (on the CPU, so the
    score program's output block runs here too; on the card B1 takes
    it)."""
    eng = zoo.serving_engine(PRESET, device="cpu", timeout_s=None)
    seen, calls = {}, []
    real = ri.dense

    def spy(x, w, b, compute_dtype=None, tanh=False):
        calls.append((x.numel() // w.shape[0], w.shape[0], w.shape[1]))
        return real(x, w, b, compute_dtype, tanh)

    rng = np.random.RandomState(0)
    ri.dense = spy
    try:
        for op, (fn, takes_k) in programs.PROGRAMS.items():
            cfg, _ = eng._kernel_for(op)
            cfg = dataclasses.replace(cfg, row_invariant=True)
            d = eng.row_dims[op]
            for bucket in BUCKETS:
                calls.clear()
                x = torch.from_numpy(rng.rand(bucket, d).astype(np.float32))
                seeds = list(range(bucket))
                if takes_k:
                    fn(eng._params, cfg, 0, seeds, x, 50)
                else:
                    fn(eng._params, cfg, 0, seeds, x)
                seen[op, bucket] = list(calls)
    finally:
        ri.dense = real
    return seen


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("op", ["score", "encode", "decode"])
def test_plan_covers_every_served_shape(served_shapes, op, bf16):
    """Each served layer gets a tile whose grid covers its output, with the
    planned CTA count: the tiles times the parts of K, one CTA per SM or
    more where the smallest tile allows it, else at least the smallest
    tile's count. A full bucket's encoder layer (64 x 784 x 200) runs 28
    tiles, in bf16 each over 4 parts of K: 112 CTAs."""
    for bucket in BUCKETS:
        shapes = served_shapes[op, bucket]
        assert shapes, (op, bucket)
        for m, k, n in shapes:
            bm, bn = ri.dense_plan(m, n)
            tiles = math.ceil(m / bm) * math.ceil(n / bn)
            ctas = ri.dense_ctas(m, n, k, bf16)
            assert ctas == tiles * ri.dense_splits(k, bf16)
            assert tiles * bm * bn >= m * n
            assert ctas >= min(ri.SMS, _smallest_tile_ctas(m, n)), \
                (op, bucket, m, k, n)
    if op != "decode":
        assert (64, 784, 200) in served_shapes[op, 64]
        assert ri.dense_ctas(64, 200, 784, bf16) == (112 if bf16 else 28)


def test_served_layers_at_k_times_bucket_rows_fill_the_card(served_shapes):
    """Every layer after the k fan-out of a full bucket (3200 rows) runs at
    least one CTA per SM."""
    wide = {(m, k, n) for m, k, n in served_shapes["score", 64] if m == 3200}
    assert wide
    for m, k, n in wide:
        assert ri.dense_ctas(m, n, k, True) >= ri.SMS, (m, k, n)


def test_splits_of_k_are_a_function_of_k_and_the_type():
    """bf16 cuts a K of more than four 64-wide slabs into ceil(slabs / 4)
    parts (at most 8); K <= 256 and every fp32 K run whole, so fp32 keeps
    one FMA chain per output."""
    assert list(inspect.signature(ri.dense_splits).parameters) == ["k",
                                                                   "bf16"]
    for k in (1, 37, 50, 100, 200, 256):
        assert ri.dense_splits(k, True) == 1
    assert ri.dense_splits(257, True) == 2
    assert ri.dense_splits(784, True) == 4
    assert ri.dense_splits(2000, True) == 8
    assert ri.dense_splits(100_000, True) == 8
    for k in (1, 784, 2000, 100_000):
        assert ri.dense_splits(k, False) == 1


def test_plan_is_a_function_of_rows_and_columns_alone():
    """The tile takes (M, N) and nothing else (not K, not the dtype), and
    is the largest tile of the menu whose grid has a CTA per SM."""
    assert list(inspect.signature(ri.dense_tile).parameters) == ["m", "n"]
    for m in (1, 7, 16, 64, 65, 200, 640, 1600, 3200, 5000):
        for n in (1, 50, 100, 200, 784):
            counts = [math.ceil(m / bm) * math.ceil(n / bn)
                      for bm, bn in ri.DENSE_TILES]
            want = next((i for i, c in enumerate(counts) if c >= ri.SMS),
                        len(counts) - 1)
            assert ri.dense_tile(m, n) == want
            assert ri.dense_plan(m, n) == ri.DENSE_TILES[want]


def test_menu_is_largest_first_and_fits_the_kernel():
    """The menu's rows are multiples of 16 and its columns of 32 (the
    kernel's warp layout), largest tile first."""
    sizes = [bm * bn for bm, bn in ri.DENSE_TILES]
    assert sizes == sorted(sizes, reverse=True)
    for bm, bn in ri.DENSE_TILES:
        assert bm % 16 == 0 and bn % 32 == 0


def test_card_test_shapes_reach_every_tile():
    """The card's tile-invariance test (M in 1..3200, N in 50..784) runs
    every tile of the menu."""
    m_values = (1, 2, 7, 16, 17, 64, 65, 200, 3200)
    tiles = {ri.dense_tile(m, n) for m in m_values
             for n in (50, 100, 200, 784)}
    assert tiles == set(range(len(ri.DENSE_TILES)))


@pytest.mark.parametrize("shape,dim", [((50, 64, 100), -1), ((50, 64, 50), -1),
                                       ((64, 784), -1), ((1, 1, 784), -1),
                                       ((50, 64), 0), ((50, 64, 50), 0),
                                       ((250, 8), 0), ((7, 33, 5), 1)])
def test_in_order_sum_matches_torch_sum(shape, dim):
    """The in-order reference of ``row_sum`` against ``torch.sum``: the same
    fp32 terms (magnitude ~1, at most 784) added in another order."""
    x = torch.from_numpy(np.random.RandomState(len(shape) + dim)
                         .randn(*shape).astype(np.float32))
    got = ri.sum_in_order(x, dim)
    assert got.shape == torch.sum(x, dim=dim).shape
    np.testing.assert_allclose(got.numpy(), torch.sum(x, dim=dim).numpy(),
                               atol=1e-4, rtol=1e-6)


def test_in_order_sum_adds_in_index_order():
    """Its chain is the sequential one: 1 + 2^-24 + 2^-24 rounds to 1 each
    time in that order, where the pairwise sum would keep 2^-23."""
    x = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24]])
    assert ri.sum_in_order(x, -1).item() == 1.0
    assert ri.sum_in_order(x.t().contiguous(), 0).item() == 1.0


@pytest.fixture
def no_launch(monkeypatch):
    """A CPU call must not reach the kernel libraries."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached a kernel launch")
    monkeypatch.setattr(_kernels, "launch", refuse)
    monkeypatch.setattr(_kernels, "entry", refuse)


def _slab_order(terms, k):
    """The CPU plain versions' order, written out: slabs of ceil(sqrt k)
    consecutive terms, each slab's terms added in order, then the slabs'
    sums added in order from 0."""
    width = math.ceil(math.sqrt(k))
    acc = None
    for s0 in range(0, k, width):
        part = terms(s0)
        for j in range(s0 + 1, min(s0 + width, k)):
            part = part + terms(j)
        acc = (0.0 + part) if acc is None else acc + part
    return acc


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 784, 200), (3200, 100, 50), (7, 37, 130),
                                   (1, 1, 1)])
def test_cpu_dense_is_the_plain_version(no_launch, m, k, n, tanh, cd):
    """On the CPU the wrapper computes the plain composition in a fixed
    order, bit for bit: bf16-rounded operands (when asked), each output's
    exact fp32 products summed in slabs (``row_invariant.slab_plan``), the
    bias, then tanh; within rounding of ``torch.matmul``'s
    (``dense_plain``)."""
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) * k ** -0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
    xr, wr = (x.to(cd).float(), w.to(cd).float()) if cd else (x, w)
    want = _slab_order(lambda j: xr[:, j, None] * wr[j], k) + b
    if tanh:
        want = torch.tanh(want)
    assert torch.equal(ri.dense(x, w, b, cd, tanh), want)
    assert torch.equal(ri.dense(x[None], w, b, cd, tanh)[0], want)
    np.testing.assert_allclose(want.numpy(),
                               ri.dense_plain(x, w, b, cd, tanh).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dim", [((50, 64, 100), -1), ((50, 64), 0),
                                       ((7, 33, 5), 1), ((1, 1, 784), -1)])
def test_cpu_fixed_sum_is_torch_sum(no_launch, shape, dim):
    """On the CPU ``fixed_sum`` is the sum in the plain versions' fixed
    slab order, bit for bit, and ``torch.sum``'s value within rounding."""
    x = torch.from_numpy(np.random.RandomState(3).randn(*shape)
                         .astype(np.float32))
    want = _slab_order(lambda j: x.select(dim, j), x.shape[dim])
    assert torch.equal(ri.fixed_sum(x, dim), want)
    assert torch.equal(ri.sum_over(x, dim, True), want)
    assert torch.equal(ri.sum_over(x, dim, False), torch.sum(x, dim=dim))
    np.testing.assert_allclose(want.numpy(), torch.sum(x, dim=dim).numpy(),
                               atol=1e-4, rtol=1e-6)


def test_cpu_wrappers_check_their_arguments():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="compute_dtype"):
        ri.dense(x, torch.zeros((8, 3)), torch.zeros(3), torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        ri.dense(torch.zeros((4, 8), device="meta"), torch.zeros((8, 3)),
                 torch.zeros(3))
    with pytest.raises(ValueError, match="unsupported device"):
        ri.fixed_sum(torch.zeros((4, 8), device="meta"), 0)

"""Why B3 and B4 (``csrc/fused_ll_fwd.cu``, ``csrc/fused_ll_bwd.cu``) run
every product as three TF32 products (3xTF32) and not one, argued in plain
torch on the CPU at the flagship's last layer (H = 200, D = 784, small k
and B).

The tensor cores read only TF32 (10 mantissa bits) from an fp32 register.
The kernels split each operand as v = hi + lo with hi = cvt.rna.tf32(v) and
lo = cvt.rna.tf32(v - hi) and accumulate lo_a hi_b + hi_a lo_b + hi_a hi_b
in fp32 per k8 step. This file emulates ``cvt.rna.tf32`` (round the fp32
mantissa to 10 bits, ties away from zero) and that sum, and holds it
against a float64 reference within the kernels' unchanged tolerances
(``chip_smoke.FLL_TOL`` for the forward, ``FLL_BWD_TOL`` for dh, dW and
db); one TF32 pass falls outside ``FLL_TOL``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import FLL_BWD_TOL, FLL_TOL  # noqa: E402

H, D = 200, 784
K8 = 8  # the MMA's k: the kernels accumulate one k8 step at a time


def rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, ties away
    from zero, still stored as fp32 (the low 13 bits zero)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(v: torch.Tensor) -> tuple:
    hi = rna_tf32(v)
    return hi, rna_tf32(v - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (fp32 [M, K] x [K, N]) as the tensor cores form it: per k8
    step, in increasing k, the products of TF32 parts added into one fp32
    accumulator; ``passes`` 3 is 3xTF32 (lo hi, hi lo, hi hi), 1 one TF32
    pass (hi hi)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], K8):
        for x, y in terms:
            # products of TF32 values are exact in fp32; the step's sum of
            # up to 8 of them is rounded once, as the accumulator is
            acc = acc + (x[:, k0:k0 + K8].double()
                         @ y[k0:k0 + K8].double()).float()
    return acc


def draws(k, b, seed):
    """The last layer's inputs at chip_smoke's scales: h ~ N(0, 1), W and
    bias ~ N(0, 0.01), binary x, cotangent g ~ N(0, 1); fp32."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (torch.from_numpy(rng.randn(k * b, H).astype(f)),
            torch.from_numpy((rng.randn(H, D) * 0.1).astype(f)),
            torch.from_numpy((rng.randn(D) * 0.1).astype(f)),
            torch.from_numpy((rng.rand(b, D) > 0.5).astype(f)),
            torch.from_numpy(rng.randn(k * b).astype(f)))


def x_rows(x, k):
    return x.repeat(k, 1)  # row r = (kk, b) reads x[b]


def forward_emulated(h, w, bias, x, k, passes):
    """B3 in fp32 with its products emulated: ``[k * B]``."""
    logits = product(h, w, passes) + bias
    ll = x_rows(x, k) * logits - torch.nn.functional.softplus(logits)
    return ll.sum(-1)


def forward_emulated_fp32(h, w, bias, x, k):
    """B3's plain version: products and sums in fp32."""
    logits = h @ w + bias
    ll = x_rows(x, k) * logits - torch.nn.functional.softplus(logits)
    return ll.sum(-1)


def forward_exact(h, w, bias, x, k):
    h, w, bias, x = (t.double() for t in (h, w, bias, x))
    logits = h @ w + bias
    return (x_rows(x, k) * logits
            - torch.nn.functional.softplus(logits)).sum(-1)


def backward_emulated(h, w, bias, x, g, k):
    """B4 in fp32 with its three products emulated in 3xTF32: (dh, dW,
    db)."""
    logits = product(h, w, 3) + bias
    dl = g[:, None] * (x_rows(x, k) - torch.sigmoid(logits))
    return (product(dl, w.t().contiguous(), 3),
            product(h.t().contiguous(), dl, 3), dl.sum(0))


def backward_exact(h, w, bias, x, g, k):
    h, w, bias, x, g = (t.double() for t in (h, w, bias, x, g))
    dl = g[:, None] * (x_rows(x, k) - torch.sigmoid(h @ w + bias))
    return dl @ w.t(), h.t() @ dl, dl.sum(0)


def outside_fwd_tol(got, want) -> torch.Tensor:
    """Rows outside FLL_TOL = (atol, rtol)."""
    return (got.double() - want).abs() > FLL_TOL[0] + FLL_TOL[1] * want.abs()


def test_rna_tf32_keeps_10_mantissa_bits_and_rounds_ties_away():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 1.0 + 3 * 2 ** -11,
                      2 - 2 ** -12, 0.0, -3.0e-38], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                         1.0 + 2 ** -9, 2.0, 0.0, -3.0e-38],
                        dtype=torch.float32)
    got = rna_tf32(v)
    assert torch.equal(got[:-1], want[:-1])
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_carries_22_bits(seed):
    """hi + lo reproduces an fp32 value to ~2^-22 of its magnitude; hi
    alone only to ~2^-11."""
    v = torch.from_numpy(np.random.RandomState(seed).randn(4096)
                         .astype(np.float32))
    hi, lo = split(v)
    assert float(((hi.double() + lo.double() - v.double()).abs()
                  / v.double().abs()).max()) <= 2 ** -21
    assert float(((hi.double() - v.double()).abs()
                  / v.double().abs()).max()) > 2 ** -13


@pytest.mark.parametrize("k,b,seed", [(4, 8, 300), (2, 16, 301), (1, 1, 302),
                                      (3, 5, 303)])
def test_three_tf32_passes_hold_the_forward_tolerance(k, b, seed):
    h, w, bias, x, _ = draws(k, b, seed)
    want = forward_exact(h, w, bias, x, k)
    got = forward_emulated(h, w, bias, x, k, passes=3)
    assert not bool(outside_fwd_tol(got, want).any())
    # as close as the plain fp32 version (cuBLAS-like fp32 sums) is, within
    # a factor that leaves the tolerance far away
    plain = forward_emulated_fp32(h, w, bias, x, k)
    err3 = float((got.double() - want).abs().max())
    err32 = float((plain.double() - want).abs().max())
    assert err3 <= 4 * err32 + 1e-4


@pytest.mark.parametrize("k,b,seed", [(4, 8, 300), (2, 16, 301)])
def test_one_tf32_pass_falls_outside_the_forward_tolerance(k, b, seed):
    """One TF32 pass per product: a quarter to a third of the flagship's
    rows move by more than FLL_TOL (worst ~2e-2 nats, ten times its atol),
    which is why the kernels take three."""
    h, w, bias, x, _ = draws(k, b, seed)
    want = forward_exact(h, w, bias, x, k)
    got = forward_emulated(h, w, bias, x, k, passes=1)
    assert float(outside_fwd_tol(got, want).double().mean()) >= 0.2
    assert float((got.double() - want).abs().max()) > 5 * FLL_TOL[0]


@pytest.mark.parametrize("k,b,seed", [(4, 8, 310), (2, 5, 311)])
def test_three_tf32_passes_hold_the_backward_tolerance(k, b, seed):
    """dh, dW and db of the 3xTF32 emulation within FLL_BWD_TOL of each
    output's largest magnitude, against float64."""
    h, w, bias, x, g = draws(k, b, seed)
    got = backward_emulated(h, w, bias, x, g, k)
    want = backward_exact(h, w, bias, x, g, k)
    for name, a, ref in zip(("dh", "dW", "db"), got, want):
        err = float((a.double() - ref).abs().max())
        scale = float(ref.abs().max())
        assert err <= FLL_BWD_TOL * scale, name

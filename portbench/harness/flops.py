"""Frozen copy of the port's analytic FLOP arithmetic and the card's peaks
(``utils/flops.py`` at commit 3ec051a), so that a later change to the port
cannot move the yardstick.

2 FLOPs per multiply-add of the model's dense layers; a training step is
the forward pass and a backward of twice its work. Elementwise work,
sampling and reductions are not counted, so a share of the peak from these
counts is a lower bound on the work done.

Peaks: NVIDIA's H100 SXM5 data sheet, dense bf16 on the tensor cores
989 TFLOP/s, HBM3 3.35 TB/s. Another card gets None: no denominator is
guessed.
"""

from __future__ import annotations

from typing import Optional

from portbench.reference.iwae import Widths

#: ``torch.cuda.get_device_name`` substrings (lower case) of the H100 SXM5
_H100_SXM = ("nvidia h100 80gb hbm3", "h100 sxm")
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def peak_flops(card: str) -> Optional[float]:
    return PEAK_BF16_FLOPS if any(s in card.lower() for s in _H100_SXM) \
        else None


def peak_bytes(card: str) -> Optional[float]:
    return PEAK_HBM_BYTES if any(s in card.lower() for s in _H100_SXM) \
        else None


def stochastic_block_macs(in_dim: int, hidden: int, latent: int) -> int:
    return in_dim * hidden + hidden * hidden + 2 * hidden * latent


def output_block_macs(in_dim: int, hidden: int, out_dim: int) -> int:
    return in_dim * hidden + hidden * hidden + hidden * out_dim


def param_count(w: Widths) -> int:
    n, in_dim = 0, w.x_dim
    for hid, lat in w.enc:
        n += stochastic_block_macs(in_dim, hid, lat) + 2 * hid + 2 * lat
        in_dim = lat
    for hid, lat in w.dec:
        n += stochastic_block_macs(in_dim, hid, lat) + 2 * hid + 2 * lat
        in_dim = lat
    return n + output_block_macs(in_dim, w.out_hidden, w.x_dim) \
        + 2 * w.out_hidden + w.x_dim


def per_row_macs(w: Widths):
    """``(macs per batch row, macs per (sample, row))`` of one forward: the
    first encoder block runs before the k fan-out."""
    (hid0, lat0), rest = w.enc[0], w.enc[1:]
    no_k = stochastic_block_macs(w.x_dim, hid0, lat0)
    per_k, in_dim = 0, lat0
    for hid, lat in rest:
        per_k += stochastic_block_macs(in_dim, hid, lat)
        in_dim = lat
    for hid, lat in w.dec:
        per_k += stochastic_block_macs(in_dim, hid, lat)
        in_dim = lat
    return no_k, per_k + output_block_macs(in_dim, w.out_hidden, w.x_dim)


def forward_flops(w: Widths, batch: int, k: int) -> float:
    no_k, per_k = per_row_macs(w)
    return 2.0 * (batch * no_k + batch * k * per_k)


def train_step_flops(w: Widths, batch: int, k: int) -> float:
    return 3.0 * forward_flops(w, batch, k)

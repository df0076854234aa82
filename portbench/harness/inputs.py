"""What the benchmark makes from ``--seed``: seeds of its own, synthetic
rows and the model's weights, all on the device.

* :func:`sub_seed` derives every seed a run uses (data, weights, the
  training stream, each evaluated batch) from ``--seed`` and a label, so
  any whole number up to 2**63 works as a seed.
* :func:`synthetic_rows` is a frozen copy of the port's
  ``data/loaders._synthetic`` (commit 3ec051a), moved to the device: ten
  digit-like templates, each a Gaussian blob plus a ring, clipped to
  [0.01, 0.95], and rows binarized once from a template drawn per row.
* :func:`init_weights` draws every Glorot-uniform kernel of the model
  (Keras ``Dense`` defaults, as the port's ``models/mlp.dense_init``) in
  one call on the device; biases start at zero, the logit layer's at the
  logit of the clipped pixel means of the training rows
  (``data/loaders.output_bias_from_pixel_means``).

The weights come out as a flat ``{name: tensor}`` dict in the order of
:func:`layout`; :func:`program_tree` arranges the same tensors as the
port's parameter tree.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from portbench.reference.iwae import Widths


def sub_seed(seed: int, *label) -> int:
    """A 63-bit seed from ``--seed`` and a label: the first 8 bytes of the
    SHA-256 of their repr."""
    digest = hashlib.sha256(repr((int(seed),) + label).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _templates(gen: torch.Generator, device) -> torch.Tensor:
    """``[10, 784]`` pixel probabilities (``_synthetic``'s templates)."""
    u = torch.rand((10, 4), generator=gen, device=device,
                   dtype=torch.float64)
    cx, cy = 0.25 + 0.5 * u[:, 0:1], 0.25 + 0.5 * u[:, 1:2]
    r1, r2 = 0.05 + 0.15 * u[:, 2:3], 0.05 + 0.15 * u[:, 3:4]
    grid = torch.arange(28, device=device, dtype=torch.float64) / 27.0
    yy = grid[:, None].expand(28, 28).reshape(1, -1)
    xx = grid[None, :].expand(28, 28).reshape(1, -1)
    blob = torch.exp(-((xx - cx) ** 2 / (2 * r1 ** 2)
                       + (yy - cy) ** 2 / (2 * r2 ** 2)))
    ring = torch.exp(-(torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) - 0.25)
                     ** 2 / 0.004)
    return torch.clamp(0.85 * blob + 0.6 * ring, 0.01, 0.95).float()


def synthetic_rows(seed: int, sizes: Tuple[int, ...], device
                   ) -> List[torch.Tensor]:
    """One ``[n, 784]`` float32 tensor of {0, 1} rows per entry of
    `sizes` (train, test), from the same ten templates."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    t = _templates(gen, device)
    out = []
    for n in sizes:
        cls = torch.randint(0, 10, (n,), generator=gen, device=device)
        probs = t.index_select(0, cls)
        out.append((torch.rand(probs.shape, generator=gen, device=device)
                    < probs).float())
    return out


def layout(widths: Widths) -> List[Tuple[str, int, int]]:
    """``(name, in, out)`` of every dense layer, in the port's tree order:
    the encoder's stochastic blocks, the decoder's, the output block."""
    out = []
    in_dim = widths.x_dim
    for i, (hid, lat) in enumerate(widths.enc):
        out += [(f"enc{i}.l1", in_dim, hid), (f"enc{i}.l2", hid, hid),
                (f"enc{i}.mu", hid, lat), (f"enc{i}.lstd", hid, lat)]
        in_dim = lat
    for i, (hid, lat) in enumerate(widths.dec):
        out += [(f"dec{i}.l1", in_dim, hid), (f"dec{i}.l2", hid, hid),
                (f"dec{i}.mu", hid, lat), (f"dec{i}.lstd", hid, lat)]
        in_dim = lat
    hid = widths.out_hidden
    out += [("out.l1", in_dim, hid), ("out.l2", hid, hid),
            ("out.out", hid, widths.x_dim)]
    return out


def init_weights(seed: int, widths: Widths, x_train: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The flat weight dict: Glorot-uniform kernels from one draw, zero
    biases, the logit layer's bias from the pixel means of `x_train`."""
    dev = x_train.device
    layers = layout(widths)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(i * o for _, i, o in layers), generator=gen,
                   device=dev)
    w, at = {}, 0
    for name, i, o in layers:
        limit = math.sqrt(6.0 / (i + o))
        w[name + ".w"] = ((u[at:at + i * o] * 2.0 - 1.0) * limit).view(i, o)
        w[name + ".b"] = torch.zeros(o, device=dev)
        at += i * o
    means = torch.clamp(x_train.mean(0), 0.001, 0.999)
    w["out.out.b"] = -torch.log(1.0 / means - 1.0)
    return w


def program_tree(w: Dict[str, torch.Tensor], widths: Widths) -> dict:
    """The port's parameter tree over the tensors of `w` (not copies)."""
    def block(prefix, keys):
        return {k: {"w": w[f"{prefix}.{k}.w"], "b": w[f"{prefix}.{k}.b"]}
                for k in keys}
    gauss = ("l1", "l2", "mu", "lstd")
    return {"enc": tuple(block(f"enc{i}", gauss)
                         for i in range(len(widths.enc))),
            "dec": tuple(block(f"dec{i}", gauss)
                         for i in range(len(widths.dec))),
            "out": block("out", ("l1", "l2", "out"))}


"""Qualitative figures: sample and reconstruction grids and the latent
scatter, as PNG files (port of ``utils/viz.py``).

The grids are the JAX module's numpy, and the figures are the ones its
driver writes per evaluation stage: ancestral samples from
:func:`..models.iwae.generate_x` and original/reconstruction pairs from
:func:`..models.iwae.reconstruct_probs` (the reference's Figures 3-5), and
for the labelled digits the posterior-mean scatter of a stochastic layer.
The JAX module encodes through PIL and draws the scatter with matplotlib;
this one needs neither: :func:`save_png` writes the PNG itself with
:mod:`zlib` and :mod:`struct`, and :func:`latent_scatter` rasterises its
points with numpy.

The draws come from a ``torch.Generator`` or are injected (``noise``,
``eps``), so tests can replay the JAX package's draws (ROADMAP rule 3).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from iwae_replication_project_tpu_torch.models import iwae as model

#: matplotlib's ``tab10`` colours (the JAX scatter's ``cmap="tab10"``), by
#: class label
TAB10 = np.array([
    (0x1f, 0x77, 0xb4), (0xff, 0x7f, 0x0e), (0x2c, 0xa0, 0x2c),
    (0xd6, 0x27, 0x28), (0x94, 0x67, 0xbd), (0x8c, 0x56, 0x4b),
    (0xe3, 0x77, 0xc2), (0x7f, 0x7f, 0x7f), (0xbc, 0xbd, 0x22),
    (0x17, 0xbe, 0xcf)], dtype=np.float32)

#: the scatter's canvas: the JAX figure's 5 in at 120 dpi
SCATTER_PX = 600
#: the radius of a point's disc in pixels: matplotlib's ``s=8`` (points
#: squared) is a disc 2.8 pt wide, 4.7 px at 120 dpi
_DOT_RADIUS = 2.4


def image_grid(images: np.ndarray, ncols: int = 10,
               img_hw: Tuple[int, int] = (28, 28), pad: int = 2) -> np.ndarray:
    """Tile ``[N, H*W]`` probabilities in [0,1] into one uint8 grid image."""
    images = np.asarray(images, dtype=np.float32)
    n = images.shape[0]
    h, w = img_hw
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.ones((nrows * (h + pad) + pad, ncols * (w + pad) + pad),
                   dtype=np.float32)
    for i in range(n):
        r, c = divmod(i, ncols)
        top = pad + r * (h + pad)
        left = pad + c * (w + pad)
        grid[top:top + h, left:left + w] = images[i].reshape(h, w)
    return (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_bytes(array_u8: np.ndarray) -> bytes:
    """The PNG file of an 8-bit image: ``[H, W]`` grayscale (colour type 0)
    or ``[H, W, 3]`` RGB (colour type 2), no interlace, filter byte 0 on
    every row, one zlib stream in one IDAT chunk."""
    a = np.ascontiguousarray(array_u8, dtype=np.uint8)
    if a.ndim == 2:
        colour = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"save_png takes [H, W] or [H, W, 3] uint8, got "
                         f"shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(array_u8: np.ndarray, path: str) -> None:
    """Write `array_u8` to `path` as a PNG file (:func:`_png_bytes`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_png_bytes(array_u8))


def _rows(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.reshape(len(x), -1).to(device)


@torch.no_grad()
def save_stage_figures(params, cfg: model.ModelConfig, x_test, out_dir: str,
                       stage: int, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[dict] = None, n_samples: int = 100,
                       n_recon: int = 20,
                       img_hw: Optional[Tuple[int, int]] = None) -> list:
    """Write ``figures/stage_{stage:02d}_samples.png`` (`n_samples`
    ancestral generations from ``h_top ~ N(0, I)``, 10 to a row) and
    ``..._recons.png`` (`n_recon` originals of `x_test` interleaved with
    their one-sample reconstructions) under `out_dir`; returns the paths
    (JAX :47-87).

    The draws come from `generator` in the order h_top, the generation's
    decoder layers, the reconstruction's encoder then decoder layers, or
    from ``noise``: ``{"h_top": [1, n_samples, d_top], "gen": [...],
    "recon_enc": [...], "recon_dec": [...]}``, the tensors
    ``generate_x``'s and ``reconstruct_probs``' ``eps`` take."""
    dev = next(iter(params["out"]["out"].values())).device
    if img_hw is None:
        side = int(round(float(np.sqrt(cfg.x_dim))))
        img_hw = (side, cfg.x_dim // side)
    noise = noise or {}
    h_top = noise.get("h_top")
    if h_top is None:
        h_top = torch.randn((1, n_samples, cfg.n_latent_enc[-1]),
                            generator=generator, device=dev)
    gen = model.generate_x(params, cfg, h_top.to(dev), generator=generator,
                           eps=noise.get("gen"))[0]
    x = _rows(x_test[:n_recon], dev)
    rec = model.reconstruct_probs(params, cfg, x, generator=generator,
                                  enc_eps=noise.get("recon_enc"),
                                  dec_eps=noise.get("recon_dec"))[0]
    paired = torch.stack([x, rec], dim=1).reshape(2 * n_recon, -1)

    fig_dir = os.path.join(out_dir, "figures")
    paths = []
    for name, arr in (("samples", gen), ("recons", paired)):
        p = os.path.join(fig_dir, f"stage_{stage:02d}_{name}.png")
        save_png(image_grid(arr.float().cpu().numpy(), ncols=10,
                            img_hw=img_hw), p)
        paths.append(p)
    return paths


def _scatter_canvas(proj: np.ndarray, labels: Optional[np.ndarray]
                    ) -> np.ndarray:
    """The ``[600, 600, 3]`` uint8 raster of the scatter."""
    size = SCATTER_PX
    canvas = np.full((size, size, 3), 255.0, np.float32)
    left, top, right, bottom = 60, 30, size - (90 if labels is not None
                                               else 30), size - 60
    # the axes' frame
    canvas[top, left:right + 1] = canvas[bottom, left:right + 1] = 0.0
    canvas[top:bottom + 1, left] = canvas[top:bottom + 1, right] = 0.0
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    margin = 8
    px = left + margin + (proj[:, 0] - lo[0]) / span[0] * (
        right - left - 2 * margin)
    py = bottom - margin - (proj[:, 1] - lo[1]) / span[1] * (
        bottom - top - 2 * margin)
    r = int(np.ceil(_DOT_RADIUS))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    alpha = 0.7 if labels is None else 0.8
    colours = TAB10[np.zeros(len(proj), np.int64) if labels is None
                    else np.asarray(labels, np.int64) % 10]
    for cx, cy, colour in zip(px, py, colours):
        ix, iy = int(round(cx)), int(round(cy))
        inside = (dx + ix - cx) ** 2 + (dy + iy - cy) ** 2 <= _DOT_RADIUS ** 2
        ys, xs = dy[inside] + iy, dx[inside] + ix
        canvas[ys, xs] = (1 - alpha) * canvas[ys, xs] + alpha * colour
    if labels is not None:
        # the class colours in label order, 0 at the top
        x0, cell = right + 30, (bottom - top) // 10
        for c in range(10):
            canvas[top + c * cell:top + (c + 1) * cell, x0:x0 + 20] = TAB10[c]
    return np.round(canvas).astype(np.uint8)


@torch.no_grad()
def latent_scatter(params, cfg: model.ModelConfig, x, path: str,
                   labels: Optional[np.ndarray] = None, layer: int = -1,
                   n_samples: int = 64, *,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[Sequence[torch.Tensor]] = None
                   ) -> np.ndarray:
    """Posterior means of one stochastic layer projected onto their top two
    principal components, the JAX package's latent view (JAX :90-115);
    returns the ``[B, 2]`` projection (PC 1 first; each component's sign is
    ``eigh``'s) and writes a PNG to `path`.

    The means average `n_samples` draws of ``encode`` (from `generator`, or
    ``eps`` as ``encode`` takes it). The picture is a 600x600 RGB raster
    (the JAX figure's 5 in at 120 dpi): a frame, each point a disc in
    matplotlib's ``tab10`` colour of its label (``labels``, e.g.
    ``data.digits_labels()``; without them all in the first colour), and
    with labels a strip of the ten class colours in label order at the
    right. It leaves out what matplotlib draws as text: the axis labels,
    the ticks, the title and the colour bar's scale."""
    dev = next(iter(params["out"]["out"].values())).device
    xt = _rows(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
               dev)
    h, _, _ = model.encode(params, cfg, xt, n_samples, generator=generator,
                           eps=eps)
    means = h[layer].float().mean(dim=0).cpu().numpy()  # E_q[h|x], [B, d]
    if means.shape[1] < 2:
        raise ValueError(
            f"latent_scatter needs a >=2-dim stochastic layer to project; "
            f"layer {layer} has dimension {means.shape[1]}")
    centered = means - means.mean(axis=0)
    cov = centered.T @ centered / len(centered)
    _, vecs = np.linalg.eigh(cov)
    proj = centered @ vecs[:, -2:][:, ::-1]  # [B, 2], PC1 first
    save_png(_scatter_canvas(proj, labels), path)
    return proj


__all__ = ["TAB10", "image_grid", "latent_scatter", "save_png",
           "save_stage_figures"]

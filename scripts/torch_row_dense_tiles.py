#!/usr/bin/env python3
"""``row_dense`` on every output tile of its menu, and the row wrappers'
host time in parts, on one NVIDIA GPU:

    python3 scripts/torch_row_dense_tiles.py

For each shape below, in bf16 and fp32: the device time of one call (a
CUDA-graph replay of 20 calls, ``chip_smoke.device_ms``) on each tile of
``ops/row_invariant.DENSE_TILES``, forced through the C entry point's
``tile`` argument, with the CTA count of each grid, the tile the plan picks
and whether every tile gave the same bits (the kernel's contract). Then the
host microseconds (median of 7 rounds of 200 calls) of a ``dense`` and a
``fixed_sum`` call and of their parts: the C entry point alone, the launch
helper, the output allocation, the launch count, the checks, and the
library calls beside them. Prints one line per result. Without a CUDA
device it exits non-zero. It imports nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: (M, K, N, tanh): the flagship's served layers at a 64-row bucket and
#: the encoder's first layer at buckets 1 and 8
SHAPES = [(64, 784, 200, True), (64, 200, 200, True), (64, 200, 784, False),
          (3200, 100, 100, False), (3200, 100, 50, False),
          (3200, 50, 100, True), (1, 784, 200, True), (8, 784, 200, True)]


def tiles(torch, cs, ri, _kernels) -> None:
    fn = _kernels.entry(ri.KERNEL_DENSE)
    for dtype in ("bf16", "fp32"):
        for i, (m, k, n, tanh) in enumerate(SHAPES):
            x, w, b = cs.row_dense_inputs(torch, m, k, n, 7 + i)
            y = torch.empty((m, n), device="cuda")
            times, outs = [], []
            for tile in range(len(ri.DENSE_TILES)):
                def call(tile=tile):
                    return _kernels.launch(
                        x.device, fn, x.data_ptr(), w.data_ptr(),
                        b.data_ptr(), y.data_ptr(), m, k, n,
                        dtype == "bf16", tanh, tile)
                if call() != 0:
                    raise RuntimeError(f"row_dense refused tile {tile}")
                torch.cuda.synchronize()
                outs.append(y.clone())
                times.append(cs.device_ms(call, torch))
            same = all(torch.equal(o, outs[0]) for o in outs)
            cells = " ".join(
                f"{ri.DENSE_TILES[t]}={times[t] * 1e3:.2f}us"
                f"({-(-m // ri.DENSE_TILES[t][0]) * -(-n // ri.DENSE_TILES[t][1])})"
                for t in range(len(times)))
            print(f"tiles {dtype} {m}x{k}x{n} parts="
                  f"{ri.dense_splits(k, dtype == 'bf16')}: {cells} plan="
                  f"{ri.dense_plan(m, n)} same_bits_across_tiles={same}",
                  flush=True)


def host_parts(torch, cs, ri, _kernels) -> None:
    x, w, b = cs.row_dense_inputs(torch, 3200, 100, 100, 1)
    cd = torch.bfloat16
    fn = _kernels.entry(ri.KERNEL_DENSE)
    y = torch.empty((3200, 100), device="cuda")
    dev = x.device
    stream = torch._C._cuda_getCurrentRawStream(0)
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr())
    args = (3200, 100, 100, 1, 0, 1)
    f32 = torch.float32

    def hu(f):
        return cs.host_us(f, torch, iters=200, rounds=7)

    parts = {
        "wrapper dense": lambda: ri.dense(x, w, b, cd, False),
        "C entry direct": lambda: fn(*ptrs, *args, stream),
        "_kernels.launch": lambda: _kernels.launch(dev, fn, *ptrs, *args),
        "new_empty": lambda: x.new_empty((3200, 100)),
        "torch.empty": lambda: torch.empty((3200, 100), dtype=f32,
                                           device=dev),
        "count": lambda: _kernels.count(ri.KERNEL_DENSE),
        "dense_tile": lambda: ri.dense_tile(3200, 100),
        "entry": lambda: _kernels.entry(ri.KERNEL_DENSE),
        "is_grad_enabled": torch.is_grad_enabled,
        "4 data_ptr": lambda: (x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               y.data_ptr()),
        "getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "getDevice": torch._C._cuda_getDevice,
        "checks": lambda: (_kernels.check_tensor("x", x, (3200, 100), dev),
                           _kernels.check_tensor("w", w, (100, 100), dev),
                           _kernels.check_tensor("b", b, (100,), dev)),
        "wrapper fixed_sum": lambda: ri.fixed_sum(y, -1),
        "torch.addmm": lambda: torch.addmm(b, x, w),
        "torch.sum": lambda: torch.sum(y, -1),
    }
    for name, f in parts.items():
        print(f"host {name}: {hu(f):.2f} us", flush=True)
    with torch.no_grad():
        print(f"host wrapper dense (no_grad): "
              f"{hu(lambda: ri.dense(x, w, b, cd, False)):.2f} us",
              flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.ops import row_invariant as ri

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    print(cs.nvidia_smi(), flush=True)
    tiles(torch, cs, ri, _kernels)
    host_parts(torch, cs, ri, _kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())

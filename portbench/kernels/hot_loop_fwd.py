"""B1, the port's ``csrc/hot_loop_fwd.cu`` (bf16 on the tensor cores): the
decoder output block and the Bernoulli log-likelihood, ``[k, B]`` rows of
``h1`` in, ``[k, B]`` log p(x|h) out.

``SEQUENCE`` is what one call launches, in order, as the device trace
names the kernels (substrings of the demangled names): the bf16 weight
preparation, then the main kernel. The work is the frozen count of
``chip_smoke.hot_loop_bound_ms`` (commit 3ec051a): 2 FLOPs per
multiply-add of the three layers, and each input read once and the output
written once, 4 bytes an element (the wrapper's fp32 tensors).
"""

SEQUENCE = ("prep_weights", "hot_loop_fwd_tc")


def work(k: int, b: int, h1: int, hid: int, d: int):
    """``(operations, bytes)`` of one call at ``[k, B]`` rows."""
    rows = k * b
    ops = 2.0 * rows * (h1 * hid + hid * hid + hid * d)
    weights = h1 * hid + hid + hid * hid + hid + hid * d + d
    nbytes = 4.0 * (rows * h1 + weights + b * d + rows)
    return ops, nbytes

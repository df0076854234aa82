"""B2, the port's ``csrc/hot_loop_bwd.cu`` (bf16 on the tensor cores): dh
and the gradients of the output block's weights and biases.

``SEQUENCE`` is what one call launches, in order, as the device trace
names the kernels: the bf16 weight preparation, the row phase, the
weight-gradient phase and the reduction of its split slots. The work is
the frozen count of ``chip_smoke.hot_loop_bwd_bound_ms`` (commit
3ec051a): the recompute and two backward products per matmul (6 FLOPs per
multiply-add); h1, the upstream gradient, x and the weights read once, dh
and the weight gradients written once, 4 bytes an element.
"""

SEQUENCE = ("prep_weights", "hot_loop_bwd_rows", "hot_loop_bwd_wgrad",
            "reduce_slots_kernel")


def work(k: int, b: int, h1: int, hid: int, d: int):
    """``(operations, bytes)`` of one call at ``[k, B]`` rows."""
    rows = k * b
    ops = 6.0 * rows * (h1 * hid + hid * hid + hid * d)
    weights = h1 * hid + hid + hid * hid + hid + hid * d + d
    nbytes = 4.0 * (rows * h1 + rows + b * d + weights + rows * h1 + weights)
    return ops, nbytes

"""The input check every kernel wrapper runs before a launch
(``ops/_kernels.check_tensor``): a contiguous fp32 tensor of the expected
shape on the expected device passes, anything else raises the error that
names what is wrong. It runs on the CPU; the wrappers call it with the
card's device."""

import pytest
import torch

from iwae_replication_project_tpu_torch.ops import _kernels

CPU = torch.device("cpu")

#: the hot-loop kernels' inputs at the flagship's train shape (k=50,
#: B=100, H1=100, hidden=200, D=784), as ops/hot_loop._check_block names them
BLOCK = [("h1", (50, 100, 100)), ("w1", (100, 200)), ("b1", (200,)),
         ("w2", (200, 200)), ("b2", (200,)), ("w3", (200, 784)),
         ("b3", (784,)), ("x", (100, 784)), ("g", (50, 100))]


@pytest.mark.parametrize("name,shape", BLOCK)
def test_accepts_a_contiguous_fp32_tensor_of_its_shape(name, shape):
    _kernels.check_tensor(name, torch.zeros(shape), shape, CPU)


def _transposed(shape):
    return torch.zeros(shape[::-1]).t()


@pytest.mark.parametrize("make,error,match", [
    (lambda s: torch.zeros(s, dtype=torch.float64), TypeError, "float32"),
    (lambda s: torch.zeros(s, dtype=torch.bfloat16), TypeError, "float32"),
    (lambda s: torch.zeros(s, dtype=torch.int32), TypeError, "float32"),
    (lambda s: torch.zeros(s[0], s[1] + 1), ValueError, "shape"),
    (lambda s: torch.zeros(1, *s), ValueError, "shape"),
    (lambda s: torch.zeros(s[0] * s[1]), ValueError, "shape"),
    (_transposed, ValueError, "contiguous"),
    (lambda s: torch.zeros(s[0], 2 * s[1])[:, ::2], ValueError, "contiguous"),
    (lambda s: torch.zeros(s, device="meta"), ValueError, "is on meta"),
])
def test_rejects_what_no_kernel_takes(make, error, match):
    shape = (100, 200)
    with pytest.raises(error, match=match):
        _kernels.check_tensor("w1", make(shape), shape, CPU)


def test_the_error_names_the_input():
    with pytest.raises(TypeError, match="^x must be float32"):
        _kernels.check_tensor("x", torch.zeros(3, dtype=torch.float64), (3,),
                              CPU)

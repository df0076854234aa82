"""The port's hot loop (iwae_replication_project_tpu_torch/ops/hot_loop.py)
against the JAX package: the plain ``decoder_score`` against JAX's
``_reference_impl`` and the interpret-mode Pallas forward, the path and
serving-gate outcomes. The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_kernels.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops import hot_loop as jhl
from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.ops import hot_loop as thl

#: odd k/batch grid plus a batch past the 128-row Pallas lane tile (a
#: PARTIAL batch tile on the JAX side), pixel counts off the 128 multiple
SHAPES = [(1, 1, 12), (3, 7, 130), (7, 17, 140), (17, 3, 12), (17, 1, 20),
          (1, 17, 20), (10, 300, 12)]
H1, HID = 8, 16

#: (atol, rtol) per compute dtype. fp32: the same arithmetic summed in
#: another order (a few ulps of sums of <= 140 pixel terms). bf16: both sides
#: round the same operands to bf16 and accumulate in fp32, but a
#: pre-activation within an fp32 rounding of a bf16 midpoint may round to a
#: neighbouring bf16 value on one side only; rows here are O(10-100) nats.
TOL = {None: (1e-4, 1e-5), "bfloat16": (2e-3, 1e-4)}


def _inputs(k, b, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(k, b, H1).astype(np.float32),
            (rs.randn(H1, HID) * 0.2).astype(np.float32),
            (rs.randn(HID) * 0.1).astype(np.float32),
            (rs.randn(HID, HID) * 0.2).astype(np.float32),
            (rs.randn(HID) * 0.1).astype(np.float32),
            (rs.randn(HID, d) * 0.2).astype(np.float32),
            (rs.randn(d) * 0.1).astype(np.float32),
            (rs.rand(b, d) > 0.5).astype(np.float32))


def _out_params(args):
    w1, b1, w2, b2, w3, b3 = (torch.from_numpy(a) for a in args[1:7])
    return {"l1": {"w": w1, "b": b1}, "l2": {"w": w2, "b": b2},
            "out": {"w": w3, "b": b3}}


def _port(args, cd):
    return thl.decoder_score(
        _out_params(args), torch.from_numpy(args[7]),
        torch.from_numpy(args[0]),
        compute_dtype=torch.bfloat16 if cd else None).numpy()


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("k,b,d", SHAPES)
def test_decoder_score_matches_jax_reference(k, b, d, cd):
    args = _inputs(k, b, d)
    want = np.asarray(jhl._reference_impl(*(jnp.asarray(a) for a in args),
                                          compute_dtype=cd))
    got = _port(args, cd)
    assert got.shape == (k, b) and np.isfinite(got).all()
    atol, rtol = TOL[cd]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("k,b,d", [(3, 7, 130), (17, 3, 12), (10, 300, 12)])
def test_decoder_score_matches_interpret_pallas(k, b, d, cd):
    """The Pallas forward in interpret mode, with the tiles the JAX tests
    use (tk = min(8, k); a 128-row partial batch tile past 128 rows)."""
    args = _inputs(k, b, d, seed=1)
    tk, tb = min(8, k), (128 if b > 128 else b)
    want = np.asarray(jhl._fwd_pallas(*(jnp.asarray(a) for a in args),
                                      tk=tk, tb=tb, interpret=True,
                                      compute_dtype=cd))
    atol, rtol = TOL[cd]
    np.testing.assert_allclose(_port(args, cd), want, atol=atol, rtol=rtol)


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the kernel's wrapper computes its plain version, and
    counts no launch."""
    args = [torch.from_numpy(a) for a in _inputs(3, 5, 12)]
    thl.reset_launch_counts()
    got = thl.fused_forward(*args)
    want = thl._reference_impl(*args)
    assert torch.equal(got, want)
    assert thl.launch_counts() == {thl.KERNEL: 0, thl.KERNEL_BWD: 0}
    with pytest.raises(ValueError, match="compute_dtype"):
        thl.fused_forward(*args, compute_dtype=torch.float16)


def test_path_selection_and_counters():
    assert thl.select_path(torch.device("cpu")) == "reference"
    assert thl.select_path(torch.device("cuda")) == "kernel"
    assert thl.select_path(torch.device("cuda"), "reference") == "reference"
    with pytest.raises(ValueError, match="needs CUDA"):
        thl.select_path(torch.device("cpu"), "kernel")
    with pytest.raises(ValueError, match="expected"):
        thl.select_path(torch.device("cuda"), "pallas")
    before = thl.path_counters().get("reference", 0)
    _port(_inputs(2, 3, 12), None)
    assert thl.path_counters()["reference"] == before + 1
    assert thl.PATH_CODES == {"reference": 0, "kernel": 2}
    assert thl.PATH_CODES["kernel"] == jhl.PATH_CODES["pallas"]


@pytest.mark.parametrize("likelihood,device,force,path", [
    ("logits", "cuda", None, "kernel"),
    ("logits", "cuda", "kernel", "kernel"),
    ("logits", "cuda", "reference", "reference"),
    ("logits", "cpu", None, "reference"),
    ("clamp", "cuda", None, "reference"),
    ("clamp", "cuda", "kernel", "reference"),
])
def test_serving_gate_outcomes(likelihood, device, force, path):
    """The JAX gate's rule (hot_loop.py:483-484): clamp models and a
    reference force keep the unfused config; logits models on CUDA bake the
    kernel pin into the dispatch config."""
    cfg = ModelConfig.two_layer(likelihood=likelihood)
    out, got = thl.serving_dispatch_config(cfg, device=torch.device(device),
                                           force=force)
    assert got == path
    if path == "kernel":
        assert out.fused_likelihood and out.hot_loop_path == "kernel"
    else:
        assert out is cfg

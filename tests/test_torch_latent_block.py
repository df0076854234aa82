"""The fused sample-level stochastic block (``ops/latent_block``) on the CPU:
its plain versions against the model's own composition, bitwise; the model's
inference path through the wrapper against the unfused path, bitwise and on
the same draws; what the dispatcher sends where and counts; and the checks
the wrapper makes before a launch. The kernel itself runs on the card
(``tests/test_torch_latent_block_cuda.py``)."""

import types

import pytest
import torch

from iwae_replication_project_tpu_torch.evaluation import metrics as tmet
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.models import mlp
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.objectives import estimators as est
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops import latent_block as lb
from iwae_replication_project_tpu_torch.ops import row_invariant as ri_ops

BF16 = tmodel.ModelConfig.two_layer(likelihood="logits",
                                    compute_dtype="bfloat16")
B, K = 6, 7


def _params(cfg=BF16, seed=0):
    return tmodel.init_params(torch.Generator().manual_seed(seed), cfg)


def _rows(seed=1, n=B):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 784), generator=g) > 0.5).float()


def _unfused(monkeypatch):
    """The model's composition as it stood before the fused block: the
    dispatcher never takes a block."""
    monkeypatch.setattr(lb, "takes", lambda cfg, p, x: False)


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sample", "density"])
def test_plain_versions_equal_the_models_composition(mode, cd):
    p = _params()
    g = torch.Generator().manual_seed(2)
    x = torch.randn((K, B, 100), generator=g)
    blk = p["enc"][1] if mode == "sample" else p["dec"][0]
    in_ = x if mode == "sample" else torch.randn((K, B, 50), generator=g)
    mu, std = mlp.stochastic_block_apply(blk, in_, BF16.std_floor, cd)
    if mode == "sample":
        eps = torch.randn((K, B, 50), generator=g)
        want_h = dist.normal_sample(mu, std, eps=eps)
        want = ri_ops.sum_over(dist.normal_log_prob(want_h, mu, std), -1,
                               False)
        got_h, got = lb.sample_plain(blk, in_, eps, BF16.std_floor, cd)
        assert torch.equal(got_h, want_h)
    else:
        want = ri_ops.sum_over(dist.normal_log_prob(x, mu, std), -1, False)
        got = lb.density_plain(blk, in_, x, BF16.std_floor, cd)
    assert got.shape == (K, B)
    assert torch.equal(got, want)


@pytest.mark.parametrize("injected", [False, True])
def test_inference_log_weights_are_bitwise_the_unfused_ones(monkeypatch,
                                                            injected):
    """Under no_grad the bf16 model takes both sample-level blocks through
    the wrapper (its plain version on the CPU): log w, every intermediate
    and the generator's state afterwards equal the unfused path's, so the
    same draws were made in the same order."""
    p, x = _params(), _rows()
    eps = None
    if injected:
        g = torch.Generator().manual_seed(9)
        eps = [torch.randn((K, B, d), generator=g) for d in (100, 50)]

    def run():
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            lw, aux = tmodel.log_weights_and_aux(p, BF16, x, K,
                                                 generator=gen, eps=eps)
        return lw, aux, gen.get_state()

    lb.reset_launch_counts()
    before = lb.counters()
    got, got_aux, got_state = run()
    after = lb.counters()
    assert after["plain"] - before["plain"] == 2   # q(h2|h1), p(h1|h2)
    assert after["kernel"] == before["kernel"]
    assert lb.launch_counts() == {lb.KERNEL: 0}
    assert got_aux["q_last"] is None
    with monkeypatch.context() as m:
        _unfused(m)
        want, want_aux, want_state = run()
    assert torch.equal(got, want)
    for key in ("log_q", "log_prior", "log_px_given_h"):
        assert torch.equal(got_aux[key], want_aux[key]), key
    for a, b in zip(got_aux["h"], want_aux["h"]):
        assert torch.equal(a, b)
    assert torch.equal(got_state, want_state)


def test_streamed_nll_is_bitwise_the_unfused_one(monkeypatch):
    p, x = _params(), _rows(n=4)

    def run():
        gen = torch.Generator().manual_seed(7)
        out = tmet.streaming_log_px(p, BF16, x, k=12, chunk=4, generator=gen)
        return out, gen.get_state()

    got, got_state = run()
    _unfused(monkeypatch)
    want, want_state = run()
    assert torch.equal(got, want)
    assert torch.equal(got_state, want_state)


@pytest.mark.parametrize("case", ["grad", "row_invariant", "fp32"])
def test_dispatcher_keeps_the_plain_path(case):
    """Autograd on, the serving programs' row-invariant ops and fp32
    operands keep the unfused composition: takes() says no and counts a
    plain decision."""
    cfg = {"grad": BF16,
           "row_invariant": tmodel.ModelConfig.two_layer(
               likelihood="logits", compute_dtype="bfloat16",
               row_invariant=True),
           "fp32": tmodel.ModelConfig.two_layer(likelihood="logits")}[case]
    p = _params(cfg)
    x = torch.randn((K, B, 100))
    before = lb.counters()
    with torch.set_grad_enabled(case == "grad"):
        assert not lb.takes(cfg, p["enc"][1], x)
    after = lb.counters()
    assert after["plain"] - before["plain"] == 1
    assert after["kernel"] == before["kernel"]


@pytest.mark.parametrize("case", ["grad", "row_invariant", "fp32",
                                  "one_layer"])
def test_models_plain_cases_never_reach_the_wrapper(monkeypatch, case):
    """The model calls the wrapper only where the dispatcher takes the
    block: never with autograd on, under row_invariant, in fp32, for the
    row-level q(h1|x) or in a one-layer model (no sample-level block)."""
    cfg = {"grad": BF16,
           "row_invariant": tmodel.ModelConfig.two_layer(
               likelihood="logits", compute_dtype="bfloat16",
               row_invariant=True),
           "fp32": tmodel.ModelConfig.two_layer(likelihood="logits"),
           "one_layer": tmodel.ModelConfig.one_layer(
               likelihood="logits", compute_dtype="bfloat16")}[case]
    calls = []
    monkeypatch.setattr(lb, "sample", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(lb, "density", lambda *a, **k: calls.append(a))
    p, x = _params(cfg), _rows()
    before = lb.counters()
    with torch.set_grad_enabled(case == "grad"):
        tmodel.log_weights(p, cfg, x, K, generator=torch.Generator())
    after = lb.counters()
    assert calls == []
    asked = 0 if case == "one_layer" else 2
    assert after["plain"] - before["plain"] == asked


def test_dispatcher_takes_inference_blocks_and_counts_the_kernel():
    """No gradient, bf16, not row-invariant, widths the kernel holds: the
    block goes to the wrapper; on CUDA tensors it is counted as the
    kernel's, on the CPU as the plain version's. Widths past the kernel's
    registers or shared memory stay unfused."""
    p = _params()
    on_card = types.SimpleNamespace(shape=(K, B, 100),
                                    device=torch.device("cuda"))
    before = lb.counters()
    with torch.no_grad():
        assert lb.takes(BF16, p["enc"][1], on_card)
        assert lb.takes(BF16, p["enc"][1], torch.zeros((K, B, 100)))
    after = lb.counters()
    assert after["kernel"] - before["kernel"] == 1
    assert after["plain"] - before["plain"] == 1
    wide = tmodel.ModelConfig(n_hidden_enc=(200, 256),
                              n_latent_enc=(100, 50),
                              n_hidden_dec=(100, 200),
                              n_latent_dec=(100, 784),
                              likelihood="logits", compute_dtype="bfloat16")
    with torch.no_grad():
        assert not lb.takes(wide, _params(wide)["enc"][1], on_card)


def test_fit_rule_mirrors_the_kernels_shared_memory():
    # the flagship's blocks: 97 KB and 115 KB of resident weights plus four
    # row groups' buffers (csrc/latent_block.cu block_smem_bytes; the card
    # tests hold the mirror to the library's own function)
    assert lb.smem_bytes(100, 100, 50) == 166912
    assert lb.smem_bytes(50, 100, 100) == 185344
    assert lb.fits(100, 100, 50) and lb.fits(50, 100, 100)
    assert lb.fits(128, 128, 64)
    assert not lb.fits(129, 100, 50)                  # registers
    assert not lb.fits(100, 129, 50)
    assert lb.smem_bytes(128, 128, 300) > 232448      # shared memory
    assert not lb.fits(128, 128, 300)


def test_vae_v1_rejects_a_fused_last_layer():
    """With the last conditional fused there is no (mu, std) to hand on:
    VAE_V1 rejects the two-layer model as it always has."""
    p, x = _params(), _rows()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="single-stochastic-layer"):
        est.objective_bound(ObjectiveSpec(name="VAE_V1", k=K), p, BF16, x,
                            generator=torch.Generator())


@pytest.mark.parametrize("case", ["no_grad", "grad", "fp32"])
def test_q_last_is_none_for_every_two_layer_path(case):
    """A two-layer encoder hands on no (mu, std), whichever path ran its
    deeper layer; a one-layer encoder hands on its [B, d] pair. VAE_V1
    rejects the two-layer model in the single-device bound and in the
    sharded one alike."""
    from iwae_replication_project_tpu_torch.parallel import dp
    from iwae_replication_project_tpu_torch.parallel.mesh import Mesh

    cfg = tmodel.ModelConfig.two_layer(likelihood="logits") \
        if case == "fp32" else BF16
    p, x = _params(cfg), _rows()
    with torch.set_grad_enabled(case == "grad"):
        lw, aux = tmodel.log_weights_and_aux(p, cfg, x, K,
                                             generator=torch.Generator())
        assert aux["q_last"] is None
        with pytest.raises(ValueError, match="single-stochastic-layer"):
            est.bound_from_log_weights(ObjectiveSpec(name="VAE_V1", k=K),
                                       lw, aux)
        with pytest.raises(ValueError, match="single-stochastic-layer"):
            dp._sharded_bound(ObjectiveSpec(name="VAE_V1", k=K), lw, aux,
                              Mesh(dp=1, sp=1, rank=0,
                                   device=torch.device("cpu")), K)
    one = tmodel.ModelConfig.one_layer(likelihood="logits",
                                       compute_dtype="bfloat16")
    with torch.set_grad_enabled(case == "grad"):
        _, aux = tmodel.log_weights_and_aux(_params(one), one, x, K,
                                            generator=torch.Generator())
    mu, std = aux["q_last"]
    assert mu.shape == std.shape == (B, one.n_latent_enc[0])


@pytest.mark.parametrize("row_invariant", [False, True])
def test_plain_versions_are_the_models_unfused_layer(row_invariant):
    """The plain versions with ``row_invariant`` and ``stop_score`` are the
    encoder's and the prior chain's layer as the model ran it before the
    fused block: the serving programs' fixed-order ops, and DReG's score
    stop, whose gradients reach the block only through the draw."""
    p = _params()
    g = torch.Generator().manual_seed(2)
    x = torch.randn((K, B, 100), generator=g)
    eps = torch.randn((K, B, 50), generator=g)
    blk = p["enc"][1]
    leaves = [t.requires_grad_(True) for t in lb._weights(blk)]
    mu, std = mlp.stochastic_block_apply(blk, x, BF16.std_floor,
                                         torch.bfloat16, row_invariant)
    want_h = dist.normal_sample(mu, std, eps=eps)
    want = ri_ops.sum_over(dist.normal_log_prob(want_h, mu.detach(),
                                                std.detach()), -1,
                           row_invariant)
    want_g = torch.autograd.grad(want.sum() + want_h.sum(), leaves)
    got_h, got = lb.sample_plain(blk, x, eps, BF16.std_floor, torch.bfloat16,
                                 row_invariant=row_invariant,
                                 stop_score=True)
    got_g = torch.autograd.grad(got.sum() + got_h.sum(), leaves)
    assert torch.equal(got_h, want_h) and torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
    with torch.no_grad():
        t = torch.randn((K, B, 100), generator=g)
        in_ = torch.randn((K, B, 50), generator=g)
        mu, std = mlp.stochastic_block_apply(p["dec"][0], in_,
                                             BF16.std_floor, torch.bfloat16,
                                             row_invariant)
        want = ri_ops.sum_over(dist.normal_log_prob(t, mu, std), -1,
                               row_invariant)
        got = lb.density_plain(p["dec"][0], in_, t, BF16.std_floor,
                               torch.bfloat16, row_invariant=row_invariant)
    assert torch.equal(got, want)


def _block_inputs(latent=50, in_dim=100, seed=0):
    p = _params(seed=seed)
    blk = p["enc"][1] if latent == 50 else p["dec"][0]
    g = torch.Generator().manual_seed(seed)
    return (blk, torch.randn((K, B, in_dim), generator=g),
            torch.randn((K, B, latent), generator=g))


def test_injected_noise_of_the_wrong_shape_raises():
    blk, x, _ = _block_inputs()
    with pytest.raises(ValueError, match="injected noise has shape"):
        lb.sample(blk, x, 1e-6, eps=torch.zeros((K, B, 49)))


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "weight",
                                   "contiguous", "compute_dtype", "grad",
                                   "width"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """The launch path's checks, run here on CPU tensors that stand in for
    the card's (the device check comes first, so each other fault is made
    on tensors that pass it by a device of their own)."""
    blk, x, noise = _block_inputs()
    if fault == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            lb._launch(blk, x, noise, None, 1e-6, torch.bfloat16)
        return
    cpu = torch.device("cpu")
    kw = {"compute_dtype": torch.bfloat16}
    if fault == "dtype":
        x = x.double()
    elif fault == "shape":
        noise = noise[..., :49].contiguous()
    elif fault == "weight":
        blk = dict(blk, mu={"w": blk["mu"]["w"][:, :49].contiguous(),
                            "b": blk["mu"]["b"]})
    elif fault == "contiguous":
        x = x.transpose(0, 1)
    elif fault == "compute_dtype":
        kw["compute_dtype"] = None
    elif fault == "width":
        x = torch.zeros((K, B, 256))
    if fault == "grad":
        x.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            lb._checked(blk, x, noise, cpu, **kw)
        return
    err = TypeError if fault == "dtype" else ValueError
    with pytest.raises(err):
        lb._checked(blk, x, noise, cpu, **kw)

"""The fused sample-level stochastic block (``csrc/latent_block.cu``) on the
card: the kernel against its plain version in both modes at the eval
chunk's shape and smaller and ragged ones, a streamed NLL batch through
the kernel against the unfused path, its launches per 2-layer chunk, and a
captured training step that launches none of it.

**Tolerance.** The kernel and its plain version take the same bf16-rounded
operands; they sum the products in another order (the tensor cores against
cuBLAS), so a hidden unit near a bf16 rounding boundary may round to the
other neighbour. The yardstick is the plain bf16 path's own distance from
fp32 on the same inputs: at the median, the 99th percentile and the largest
element, the kernel's distance from the plain bf16 version must be at most
half the plain bf16 version's distance from fp32. Measured on the card at
250 x 500 on the flagship's initial weights: a sixth of it at most (log q),
a sixtieth (p density).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_latent_block_cuda.py -m cuda
"""

import pytest
import torch

from iwae_replication_project_tpu_torch.evaluation import metrics as tmet
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.models import mlp
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.ops import latent_block as lb
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig

#: the kernel's distance from the plain bf16 version, as a share of the
#: plain bf16 version's distance from fp32 (module docstring)
SHARE = 0.5
QUANTILES = (0.5, 0.99, 1.0)

CFG = tmodel.ModelConfig.two_layer(likelihood="logits",
                                   compute_dtype="bfloat16",
                                   fused_likelihood=True)
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the latent block kernel has no CPU "
                    "mode (its plain versions are tested in "
                    "test_torch_latent_block.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(cfg=CFG):
    return tmodel.to_device(
        tmodel.init_params(torch.Generator().manual_seed(0), cfg), "cuda")


def _quantiles(t):
    v = t.abs().flatten().double()
    if v.numel() > 1 << 20:       # torch.quantile's input limit
        v = v[torch.randperm(v.numel(), device=v.device)[:1 << 20]]
    return torch.quantile(v, torch.tensor(QUANTILES, dtype=torch.float64,
                                          device=v.device)).tolist()


def _assert_within_spread(kernel, plain16, plain32, what):
    got, spread = _quantiles(kernel - plain16), _quantiles(plain16 - plain32)
    for q, g, s in zip(QUANTILES, got, spread):
        assert g <= SHARE * s, (f"{what}: at quantile {q} the kernel is {g} "
                                f"from the plain bf16 version, whose own "
                                f"distance from fp32 is {s}")


def _block_inputs(k, b, seed=3):
    """h1 drawn through q(h1|x) from binary rows, h2 through q(h2|h1), and
    the q block's noise, all on the card."""
    p = _params()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.rand((b, 784), generator=gen, device="cuda") > 0.5).float()
    with torch.no_grad():
        mu, std = mlp.stochastic_block_apply(p["enc"][0], x, CFG.std_floor,
                                             BF16)
        h1 = dist.normal_sample(mu, std, (k,), generator=gen)
        eps = torch.randn((k, b, 50), generator=gen, device="cuda")
        h2 = lb.sample_plain(p["enc"][1], h1, eps, CFG.std_floor)[0]
    return p, h1, h2, eps


SHAPES = [(250, 500), (50, 100), (13, 37), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", SHAPES)
def test_sample_mode_matches_plain_version(cuda, k, b):
    p, h1, _, eps = _block_inputs(k, b)
    blk = p["enc"][1]
    lb.reset_launch_counts()
    with torch.no_grad():
        h, lq = lb.sample(blk, h1, CFG.std_floor, BF16, eps=eps)
        h16, lq16 = lb.sample_plain(blk, h1, eps, CFG.std_floor, BF16)
        h32, lq32 = lb.sample_plain(blk, h1, eps, CFG.std_floor, None)
    torch.cuda.synchronize()
    assert lb.launch_counts() == {lb.KERNEL: 1}
    assert lq.shape == (k, b) and h.shape == (k, b, 50)
    _assert_within_spread(lq, lq16, lq32, "log q")
    _assert_within_spread(h, h16, h32, "h2")


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", SHAPES)
def test_density_mode_matches_plain_version(cuda, k, b):
    p, h1, h2, _ = _block_inputs(k, b)
    blk = p["dec"][0]
    lb.reset_launch_counts()
    with torch.no_grad():
        lp = lb.density(blk, h2, h1, CFG.std_floor, BF16)
        lp16 = lb.density_plain(blk, h2, h1, CFG.std_floor, BF16)
        lp32 = lb.density_plain(blk, h2, h1, CFG.std_floor, None)
    torch.cuda.synchronize()
    assert lb.launch_counts() == {lb.KERNEL: 1}
    assert lp.shape == (k, b)
    _assert_within_spread(lp, lp16, lp32, "log p(h1|h2)")


@pytest.mark.cuda
def test_fit_rule_matches_the_library(cuda):
    """The wrapper decides which widths the kernel takes without loading
    the library (a process that never launches it never builds it): its
    shared-memory figure and its fit rule are the library's own."""
    from iwae_replication_project_tpu_torch.ops import _kernels
    lib = _kernels.load(lb.KERNEL)
    for in_dim in (1, 16, 50, 100, 128, 129, 200):
        for hid in (8, 100, 128, 129):
            for latent in (1, 50, 100, 300):
                smem = lib.latent_block_smem_bytes(in_dim, hid, latent)
                assert lb.smem_bytes(in_dim, hid, latent) == smem
                assert lb.fits(in_dim, hid, latent) == bool(
                    lib.latent_block_fits(in_dim, hid)
                    and smem <= _kernels.MAX_SMEM_BYTES)


@pytest.mark.cuda
def test_kernel_row_does_not_depend_on_its_batch(cuda):
    """A row's result is the same bits whatever rows share the call."""
    p, h1, h2, eps = _block_inputs(13, 37)
    with torch.no_grad():
        _, full = lb.sample(p["enc"][1], h1, CFG.std_floor, BF16, eps=eps)
        _, part = lb.sample(p["enc"][1], h1[:5].contiguous(), CFG.std_floor,
                            BF16, eps=eps[:5].contiguous())
        dfull = lb.density(p["dec"][0], h2, h1, CFG.std_floor, BF16)
        dpart = lb.density(p["dec"][0], h2[3:4].contiguous(),
                           h1[3:4].contiguous(), CFG.std_floor, BF16)
    assert torch.equal(full[:5], part)
    assert torch.equal(dfull[3:4], dpart)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p, h1, h2, eps = _block_inputs(4, 8)
    blk = p["enc"][1]
    with torch.no_grad():
        with pytest.raises(TypeError):
            lb.sample(blk, h1.double(), CFG.std_floor, BF16, eps=eps)
        with pytest.raises(ValueError, match="contiguous"):
            lb.sample(blk, h1.transpose(0, 1), CFG.std_floor, BF16,
                      eps=eps.transpose(0, 1))
        with pytest.raises(ValueError, match="shape"):
            lb.density(p["dec"][0], h2, h1[..., :99].contiguous(),
                       CFG.std_floor, BF16)
        with pytest.raises(ValueError, match="bf16"):
            lb.density(p["dec"][0], h2, h1, CFG.std_floor, None)
        with pytest.raises(ValueError, match="is on"):
            lb.density(p["dec"][0], h2, h1.cpu(), CFG.std_floor, BF16)
    with pytest.raises(RuntimeError, match="no backward"):
        lb.sample(blk, h1.requires_grad_(True), CFG.std_floor, BF16, eps=eps)


@pytest.mark.cuda
def test_streamed_nll_batch_through_the_kernel(cuda, monkeypatch):
    """One k=500 batch of the streamed NLL: the kernel path against the
    unfused bf16 path and the fp32 model on the same draws, per row."""
    x = (torch.rand((100, 784), generator=torch.Generator().manual_seed(4))
         > 0.5).float().cuda()
    p = _params()

    def nll(cfg):
        gen = torch.Generator(device="cuda").manual_seed(6)
        return tmet.streaming_log_px(p, cfg, x, k=500, chunk=250,
                                     generator=gen)

    lb.reset_launch_counts()
    got = nll(CFG)
    assert lb.launch_counts() == {lb.KERNEL: 4}
    fp32 = nll(tmodel.ModelConfig.two_layer(likelihood="logits",
                                            fused_likelihood=True))
    monkeypatch.setattr(lb, "takes", lambda cfg, blk, t: False)
    plain = nll(CFG)
    assert lb.launch_counts() == {lb.KERNEL: 4}
    _assert_within_spread(got, plain, fp32, "log p(x)")


@pytest.mark.cuda
def test_launches_per_two_layer_chunk(cuda):
    """The derived count: one q(h2|h1) and one p(h1|h2) launch per chunk,
    beside B1's one; the dispatcher counts each as the kernel's."""
    x = (torch.rand((20, 784), generator=torch.Generator().manual_seed(4))
         > 0.5).float().cuda()
    p = _params()
    lb.reset_launch_counts()
    thl.reset_launch_counts()
    before = lb.counters()
    tmet.streaming_log_px(p, CFG, x, k=60, chunk=20,
                          generator=torch.Generator(device="cuda"))
    torch.cuda.synchronize()
    after = lb.counters()
    assert lb.launch_counts() == {lb.KERNEL: 2 * 3}
    assert thl.launch_counts()[thl.KERNEL] == 3
    assert after["kernel"] - before["kernel"] == 2 * 3
    assert after["plain"] == before["plain"]


@pytest.mark.cuda
def test_captured_training_step_launches_none_of_it(cuda):
    """Training runs under autograd: the step's graph records B1 and B2
    once each, as before, and no latent block."""
    cfg = ExperimentConfig().model_config("cuda")
    x = (torch.rand((300, 784), generator=torch.Generator().manual_seed(0))
         > 0.5).float().cuda()
    graph = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=50), cfg, 300,
                                 100, cuda_graph=True)
    state = ts.create_train_state(0, cfg)
    lb.reset_launch_counts()
    state, _ = graph(state, x)
    torch.cuda.synchronize()
    entry = next(iter(state.graphs.values()))
    assert entry.steps[False].launches == {thl.KERNEL: 1, thl.KERNEL_BWD: 1}
    assert lb.launch_counts() == {lb.KERNEL: 0}

"""The port's training step as a CUDA graph, on the card: replayed steps
against eager steps of the same state and generator, bitwise; the launch
counts across replays; several passes per call; and C5, a bf16 model whose
256-wide output block the kernels refuse, training and scoring through the
reference path.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
)
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

N_TRAIN, BATCH, K = 300, 100, 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode (the eager step they replay is tested "
                    "against JAX in test_torch_training.py and "
                    "test_torch_driver.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(binarize: bool):
    x = torch.rand((N_TRAIN, 784), generator=torch.Generator().manual_seed(0))
    return (x if binarize else (x > 0.5).float()).cuda()


def _state_leaves(state):
    out = [p.detach() for p in tree_leaves(state.params)]
    for p in tree_leaves(state.params):
        out += [state.optimizer.state[p][k]
                for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


def _assert_same(a, b):
    for x, y in zip(_state_leaves(a), _state_leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


def _fns(cfg, binarize, diag, **kw):
    spec = ObjectiveSpec(name="IWAE", k=K)
    d = DiagnosticsConfig(snr_window=2) if diag else None
    return [tepoch.make_epoch_fn(spec, cfg, N_TRAIN, BATCH,
                                 stochastic_binarization=binarize,
                                 diagnostics=d, cuda_graph=g, **kw)
            for g in (False, True)]


FLAGSHIP = ExperimentConfig().model_config("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("binarize,diag", [(False, False), (True, True)])
def test_graph_replays_match_eager_steps_bitwise(cuda, binarize, diag):
    """Two passes of three steps: the graph's first pass runs its first
    step eagerly, captures, and replays two; its second pass replays all
    three. Parameters, Adam moments and step counts, the generator, the
    losses and the SNR scalars equal the eager path's bit for bit."""
    x = _data(binarize)
    eager, graph = _fns(FLAGSHIP, binarize, diag)
    sa = ts.create_train_state(0, FLAGSHIP)
    sb = ts.create_train_state(0, FLAGSHIP)
    for _ in range(2):
        sa, oa = eager(sa, x)
        sb, ob = graph(sb, x)
        torch.cuda.synchronize()
        _assert_same(sa, sb)
        if diag:
            (oa, da), (ob, db) = oa, ob
            for key in da:
                assert torch.equal(da[key], db[key]), key
        assert torch.equal(oa, ob)
    assert len(sb.graphs) == 1 and not sa.graphs


#: the capturable Adam forms 1 - beta2^t on the device in float32 from
#: beta2 = 0.999 rounded to float32: 1.3e-5, 2.0e-5 and 0.7e-5 off in
#: relative terms at t = 1, 2, 3, and half that after its square root,
#: which divides the update (up to 9.8e-6); the plain one forms it on the
#: host in float64. So each step's update may be off by this share of
#: itself, and Adam keeps an update near its rate: a param may be off by
#: this share of the rates summed (where updates cancel its start value,
#: of more than itself). A rate or bias correction left behind moves the
#: update by a factor, not by 1e-5.
ADAM_UPDATE_RTOL = 2e-5


def _adam_against_plain(state, ref, ref_opt, rates):
    """Params and Adam moments of `state` against torch's plain Adam's
    after steps at `rates`: the moments within a few float32 ulps, the
    params within the float32 error of the bias correction (above), and
    the same step count."""
    leaves = tree_leaves(state.params)
    for p, q in zip(leaves, ref):
        torch.testing.assert_close(p.detach(), q.detach(),
                                   rtol=ADAM_UPDATE_RTOL,
                                   atol=ADAM_UPDATE_RTOL * sum(rates))
        got, want = state.optimizer.state[p], ref_opt.state[q]
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got[key], want[key], rtol=1e-6,
                                       atol=1e-12)
        assert float(got["step"]) == float(want["step"])


def _adam_steps(state, grads, late, graph):
    """One step on ``grads[0]`` at the state's rate, then the rate set to
    `late` and steps on the rest, eagerly or replayed from a graph of the
    step captured before the rate changed; the graph is released before
    the caller's checks."""
    static = [torch.empty_like(g) for g in grads[0]]
    step_graph = None
    for i, gs in enumerate(grads):
        for buf, g in zip(static, gs):
            buf.copy_(g)
        if i == 0:
            ts.apply_gradients(state, static)
            if graph:
                step_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(step_graph):
                    ts.apply_gradients(state, static)
            ts.set_learning_rate(state, late)
        elif graph:
            step_graph.replay()
        else:
            ts.apply_gradients(state, static)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
def test_capturable_adam_takes_a_later_stage_rate(cuda, graph):
    """make_adam's capturable Adam, whose learning rate set_learning_rate
    writes into a device tensor, against torch's plain Adam with a float
    rate (the CPU's optimizer) on the same fixed gradients: one step at the
    first stage's rate, then two at stage 4's, eagerly or replayed from a
    graph captured before the rate changed. A reference that kept the old
    rate must disagree, so the check sees a rate left behind."""
    state = ts.create_train_state(0, FLAGSHIP)
    assert state.optimizer.defaults["capturable"]
    leaves = tree_leaves(state.params)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen).cuda() for p in leaves]
             for _ in range(3)]
    early, late = 1e-3, 1e-3 * 10 ** (-3 / 7)
    start = [p.detach().clone() for p in leaves]

    def plain(rates):
        ref = [p.clone().requires_grad_(True) for p in start]
        opt = torch.optim.Adam(ref, lr=rates[0], betas=ts.ADAM_BETAS,
                               eps=ts.ADAM_EPS)
        for lr, gs in zip(rates, grads):
            opt.param_groups[0]["lr"] = lr
            for q, g in zip(ref, gs):
                q.grad = -g
            opt.step()
        return ref, opt, rates

    _adam_steps(state, grads, late, graph)
    _adam_against_plain(state, *plain([early, late, late]))
    with pytest.raises(AssertionError):
        _adam_against_plain(state, *plain([early, early, early]))


@pytest.mark.cuda
def test_launch_counts_are_exact_across_replays(cuda):
    """B1 and B2 once per step, whether the step ran eagerly, was captured
    (which launches nothing) or was replayed."""
    x = _data(False)
    _, graph = _fns(FLAGSHIP, False, False)
    state = ts.create_train_state(0, FLAGSHIP)
    thl.reset_launch_counts()
    for calls in (1, 2, 3):
        state, _ = graph(state, x)
        torch.cuda.synchronize()
        assert thl.launch_counts() == {thl.KERNEL: 3 * calls,
                                       thl.KERNEL_BWD: 3 * calls}
    entry = next(iter(state.graphs.values()))
    assert entry.steps[False].launches == {thl.KERNEL: 1, thl.KERNEL_BWD: 1}


@pytest.mark.cuda
def test_capture_survives_dead_graphs_collected(cuda, monkeypatch):
    """A graph left in a dead reference cycle (an earlier state's: its
    optimizer is such a cycle) is not destroyed inside a later capture,
    which would invalidate the capture: with the collector set to run at
    every allocation and the cycle made just as the step's capture begins,
    the collector waits until the capture is over."""
    import gc

    dead = torch.cuda.CUDAGraph()
    t = torch.zeros(1, device="cuda")
    with torch.cuda.graph(dead):
        t.add_(1)
    holder = [dead]
    del dead
    real = torch.cuda.graph

    class graph(real):
        def __enter__(self):
            out = super().__enter__()
            if holder:
                cycle = [holder.pop()]
                cycle.append(cycle)
                del cycle
            return out

    x = _data(False)
    eager, fast = _fns(FLAGSHIP, False, False)
    sa = ts.create_train_state(2, FLAGSHIP)
    sb = ts.create_train_state(2, FLAGSHIP)
    sa, _ = eager(sa, x)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        sb, _ = fast(sb, x)
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    assert not holder
    _assert_same(sa, sb)


@pytest.mark.cuda
def test_passes_per_call_on_the_graph(cuda):
    """epochs_per_call=3 on the graph path equals three calls of one."""
    x = _data(True)
    spec = ObjectiveSpec(name="IWAE", k=K)
    one, three = (tepoch.make_epoch_fn(spec, FLAGSHIP, N_TRAIN, BATCH,
                                       stochastic_binarization=True,
                                       epochs_per_call=e) for e in (1, 3))
    sa = ts.create_train_state(1, FLAGSHIP)
    sb = ts.create_train_state(1, FLAGSHIP)
    outs = []
    for _ in range(3):
        sa, out = one(sa, x)
        outs.append(out)
    sb, got = three(sb, x)
    torch.cuda.synchronize()
    _assert_same(sa, sb)
    assert torch.equal(got, torch.cat(outs))


@pytest.mark.cuda
def test_restored_state_is_captured_again(cuda):
    """A graph is bound to the tensors it captured: after a restore writes
    new Adam state into the state, the next call captures again, and the
    run goes on as the eager one."""
    import tempfile

    from iwae_replication_project_tpu_torch.utils import checkpoint as ck
    x = _data(False)
    eager, graph = _fns(FLAGSHIP, False, False)
    sa = ts.create_train_state(0, FLAGSHIP)
    sb = ts.create_train_state(0, FLAGSHIP)
    sa, _ = eager(sa, x)
    sb, _ = graph(sb, x)
    with tempfile.TemporaryDirectory() as d:
        ck.save_checkpoint(d, sb.step, sb, stage=1)
        ck.restore_latest(d, sb)
    assert not sb.graphs
    sa, _ = eager(sa, x)
    sb, _ = graph(sb, x)
    torch.cuda.synchronize()
    _assert_same(sa, sb)


@pytest.mark.cuda
def test_wide_bf16_block_trains_and_scores_through_reference(cuda):
    """C5: bf16 with a 256-wide output block is beyond B1's and B2's
    register budget. The dispatcher takes the reference path (recorded on
    kernel_path/reference) in training and serving, launching neither
    kernel, while the flagship still takes the kernels."""
    cfg = ExperimentConfig(n_hidden_decoder=(100, 256)).model_config("cuda")
    assert cfg.fused_likelihood and cfg.compute_dtype == "bfloat16"
    assert "register" in thl.block_refusal(
        thl.library_limits(100, 256, True))
    assert thl.select_path(cuda, widths=(100, 256, True)) == "reference"
    assert thl.select_path(cuda, widths=(100, 200, True)) == "kernel"
    before = thl.path_counters().get("reference", 0)
    thl.reset_launch_counts()
    _, graph = _fns(cfg, False, False)
    state = ts.create_train_state(0, cfg)
    state, losses = graph(state, _data(False))
    assert torch.isfinite(losses).all() and state.step == 3
    eng = ServingEngine(params=state.params, model_config=cfg, k=K,
                        timeout_s=None)
    got = eng.score((np.random.RandomState(0).rand(5, 784) > 0.5)
                    .astype(np.float32))
    torch.cuda.synchronize()
    assert np.isfinite(got).all()
    assert thl.launch_counts() == {thl.KERNEL: 0, thl.KERNEL_BWD: 0}
    assert thl.path_counters()["reference"] > before
    with pytest.raises(ValueError, match="refuses"):
        ServingEngine(params=state.params, model_config=cfg, k=K,
                      kernel_path="kernel")

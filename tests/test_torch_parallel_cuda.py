"""The port's mesh on the card: an NCCL world of one process, whose
parallel epoch replays its CUDA graph with the ``all_reduce`` captured in
it, and a gloo world of four processes on the one card, whose sharded step
and k-sharded NLL hold against the single-process ones on the same draws.
Small widths; the flagship runs in chip_smoke.py's phase 8.

With four cards or more, a (2, 2) NCCL world of one process per card runs
the same two checks: graph against eager, and the sharded step and NLL
against the single-process ones.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.ops import hot_loop
from iwae_replication_project_tpu_torch.parallel import dp as pdp
from iwae_replication_project_tpu_torch.parallel import make_mesh, multihost
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
import torch_parallel_worker as W

N_TRAIN, BATCH, K = 240, 40, 16
#: a small bf16 model whose decoder block the kernels take
CFG = ModelConfig(n_hidden_enc=(64,), n_latent_enc=(16,),
                  n_hidden_dec=(64,), n_latent_dec=(784,),
                  likelihood="logits", compute_dtype="bfloat16",
                  fused_likelihood=True)
#: the sharded step against the single-process one on the same draws, bf16
#: (chip_smoke.py's TOL["bf16"] for the bound, GRAD_TOL per leaf relative to
#: its largest magnitude): B1 and B2 take other row counts per launch, and
#: the partials are summed over the ranks in another order
BOUND_ATOL, GRAD_TOL, NLL_ATOL = 1e-2, 2e-2, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL, CUDA graphs and the kernels "
                    "have no CPU mode (the mesh's arithmetic is held "
                    "against JAX on the CPU in test_torch_parallel.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tensors(state):
    out = [p.detach() for p in tree_leaves(state.params)]
    for p in tree_leaves(state.params):
        out += [state.optimizer.state[p][k]
                for k in ("exp_avg", "exp_avg_sq", "step")]
    out.append(state.generator.get_state())
    out += [state.streams[k].get_state() for k in sorted(state.streams)]
    return out


@pytest.mark.cuda
def test_nccl_world_of_one_graph_eager_and_single_device(cuda, tmp_path):
    x = (torch.rand((N_TRAIN, 784), generator=torch.Generator()
                    .manual_seed(0)) > 0.5).float().to(cuda)
    spec = ObjectiveSpec(name="IWAE", k=K)
    steps = N_TRAIN // BATCH
    multihost.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                         device=cuda)
    try:
        mesh = make_mesh(1, 1, device=cuda)
        assert mesh.backend == "nccl"

        def fresh():
            return pdp.parallel_train_state(mesh, ts.create_train_state(
                0, CFG, device=cuda))

        fns = [pdp.make_parallel_epoch_fn(spec, CFG, mesh, N_TRAIN, BATCH,
                                          cuda_graph=g)
               for g in (False, True)]
        states = [fresh(), fresh()]
        for _ in range(3):
            losses = []
            for i, fn in enumerate(fns):
                hot_loop.reset_launch_counts()
                states[i], out = fn(states[i], x)
                torch.cuda.synchronize()
                assert hot_loop.launch_counts() == {
                    hot_loop.KERNEL: steps, hot_loop.KERNEL_BWD: steps}
                losses.append(out)
            assert torch.equal(*losses)
            assert all(torch.equal(a, b) for a, b in
                       zip(_tensors(states[0]), _tensors(states[1])))
        assert states[1].graphs and not states[0].graphs

        g = torch.Generator().manual_seed(1)
        perm = torch.randperm(N_TRAIN, generator=g)
        noise = [[torch.randn((K, BATCH, 16), generator=g).to(cuda)]
                 for _ in range(steps)]
        a = fresh()
        b = ts.create_train_state(0, CFG, device=cuda)
        a, la = fns[1](a, x, perm=perm, noise=noise)
        b, lb = tepoch.make_epoch_fn(spec, CFG, N_TRAIN, BATCH)(
            b, x, perm=perm, noise=noise)
        assert torch.equal(la, lb)
        assert all(torch.equal(u, v) for u, v in
                   zip(_tensors(a)[:-3], _tensors(b)[:-1]))
    finally:
        multihost.shutdown()


def _step_and_nll_payload(**over):
    rs = np.random.RandomState(2)
    state = ts.create_train_state(3, CFG, device="cpu")
    payload = dict(
        device="cuda", dp=2, sp=2,
        cfg=dict(n_hidden_enc=(64,), n_latent_enc=(16,), n_hidden_dec=(64,),
                 n_latent_dec=(784,), likelihood="logits",
                 compute_dtype="bfloat16", fused_likelihood=True),
        params=W.numpy_tree(state.params),
        x=(rs.rand(BATCH, 784) > 0.5).astype(np.float32),
        eps=[rs.randn(K, BATCH, 16).astype(np.float32)],
        names=["IWAE", "DReG"], nll_x=(rs.rand(64, 784) > 0.5)
        .astype(np.float32), nll_k=400, nll_chunk=50)
    payload.update(over)
    return payload


def _check_step_and_nll(payload, ranks):
    r0 = ranks[0]
    for res in ranks:
        assert res["max"] == 3.0  # the all_reduce takes MAX on CUDA tensors
        assert res["nll"] == r0["nll"]
        assert res["launches"][hot_loop.KERNEL] > 0
    for name in payload["names"]:
        bound, grads = r0["got"][name]
        want, ref = r0["ref"][name]
        assert abs(bound - want) <= BOUND_ATOL
        for a, b in zip(grads, ref):
            assert float((a - b).abs().max()) <= \
                GRAD_TOL * float(b.abs().max()) + 1e-6
        for res in ranks[1:]:
            assert res["got"][name][0] == bound
    assert abs(r0["nll"] - r0["ref_nll"]) <= NLL_ATOL


@pytest.mark.cuda
def test_gloo_world_of_four_on_one_card(cuda, tmp_path):
    payload = _step_and_nll_payload()
    _check_step_and_nll(payload, W.launch("cuda_step_and_nll", 4, payload,
                                          tmp_path))


@pytest.mark.cuda
def test_nccl_mesh_of_four_cards(cuda, tmp_path):
    """One process per card over NCCL, mesh (2, 2): graph replay (the
    all_reduce on the world and the sp collectives inside it) against
    eager passes, bitwise on every rank, and every rank one replica; the
    sharded step and NLL against the single-process ones."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one NCCL rank per card); the one-card "
                    "tests above run the same mesh under gloo")
    rs = np.random.RandomState(4)
    payload = dict(backend="nccl", dp=2, sp=2, batch=BATCH, passes=2,
                   cfg=_step_and_nll_payload()["cfg"],
                   x=rs.rand(N_TRAIN, 784).astype(np.float32),
                   case=dict(name="IWAE", k=K, k2=1, p=1.0, alpha=1.0,
                             beta=0.5))
    ranks = W.launch("cuda_graph_vs_eager", 4, payload, tmp_path)
    steps = N_TRAIN // BATCH
    for res in ranks:
        assert res["backend"] == "nccl" and res["graphs"] > 0
        assert res["same"]
        assert all(c == {hot_loop.KERNEL: steps, hot_loop.KERNEL_BWD: steps}
                   for c in res["launches"])
        assert all(torch.equal(a, b) for a, b in zip(res["params"],
                                                     ranks[0]["params"]))
    payload = _step_and_nll_payload(backend="nccl")
    _check_step_and_nll(payload, W.launch("cuda_step_and_nll", 4, payload,
                                          tmp_path / "step"))

"""The sharded large-k engine on the card (serving/sharded.py): B1's
launches per dispatch (``ceil(k/k_chunk)`` for ``score``; the rounds run
plus ``max ceil(k_used/k_chunk)`` for ``score_adaptive``), the kernel
against the reference path on the same device draws, and the engine
against its offline twin, bitwise. Small widths whose output block the
kernels take; the flagship runs in chip_smoke.py's phase 10.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_serving_cuda.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.ops import hot_loop
from iwae_replication_project_tpu_torch.parallel import eval as peval
from iwae_replication_project_tpu_torch.serving.sharded import (
    ShardedScoreEngine,
)

KC = 32
CFG = ModelConfig(n_hidden_enc=(64,), n_latent_enc=(16,), n_hidden_dec=(64,),
                  n_latent_dec=(784,), likelihood="logits",
                  compute_dtype="bfloat16")
#: kernel against reference, per score: chip_smoke.py's B1 row tolerance
#: (a score is a logmeanexp of rows that differ by at most that)
TOL = {"bf16": (1e-2, 1e-5), "fp32": (2e-3, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 has no CPU mode (the sharded "
                    "programs are held against JAX on the CPU in "
                    "test_torch_sharded_serving.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _engine(**kw):
    params = init_params(torch.Generator().manual_seed(1), CFG)
    kw.setdefault("k", 64)
    return ShardedScoreEngine(params=params, model_config=CFG, k_chunk=KC,
                              k_max=512, max_batch=8, max_wait_us=1e7,
                              timeout_s=120.0, **kw)


def _rows(n, seed=0):
    return (np.random.RandomState(seed).rand(n, 784) > 0.5).astype(
        np.float32)


def _serve(eng, op, x, seeds, **kw):
    fs = [eng.submit(op, r, seed=s, **kw) for s, r in zip(seeds, x)]
    eng.flush()
    return np.stack([f.result(timeout=120) for f in fs])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, KC, KC + 1, 300])
def test_b1_launches_once_per_block(cuda, k):
    eng = _engine()
    eng.warmup()
    torch.cuda.synchronize()
    hot_loop.reset_launch_counts()
    out = _serve(eng, "score", _rows(8), range(8), k=k)
    torch.cuda.synchronize()
    assert np.isfinite(out).all()
    assert hot_loop.launch_counts() == {hot_loop.KERNEL: -(-k // KC),
                                        hot_loop.KERNEL_BWD: 0}


@pytest.mark.cuda
def test_adaptive_b1_launches_follow_k_used(cuda):
    eng = _engine()
    eng.warmup()
    torch.cuda.synchronize()
    hot_loop.reset_launch_counts()
    out = _serve(eng, "score_adaptive", _rows(8, 1), range(8), k=512,
                 target_se=0.3)
    torch.cuda.synchronize()
    blocks = max(math.ceil(u / KC) for u in out[:, 2])
    # a world of one: phase 1 runs one block a round, as many rounds as the
    # slowest row's blocks; phase 2 recomputes that many
    assert hot_loop.launch_counts()[hot_loop.KERNEL] == 2 * blocks


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_kernel_matches_reference_on_the_sharded_path(cuda, precision):
    got, want = (_serve(_engine(kernel_path=p, precision=precision),
                        "score", _rows(8, 2), range(8), k=300)
                 for p in ("kernel", "reference"))
    atol, rtol = TOL[precision]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_engine_equals_offline_twin_on_the_card(cuda):
    eng = _engine()
    x, seeds = _rows(8, 3), list(range(30, 38))
    got = _serve(eng, "score", x, seeds, k=300)
    got_a = _serve(eng, "score_adaptive", x, seeds, k=300, target_se=0.3)
    xt = torch.from_numpy(x).cuda()
    want = peval.sharded_score_offline(eng._params, eng.cfg, eng.mesh, 0,
                                       seeds, xt, 300, KC)
    want_a = peval.sharded_score_adaptive_offline(
        eng._params, eng.cfg, eng.mesh, 0, seeds, xt, k_cap=300,
        target_se=0.3, k_chunk=KC)
    assert np.array_equal(got, want.cpu().numpy())
    assert np.array_equal(got_a, want_a.cpu().numpy())

"""The serving tier on the card (serving/frontend/ over the port's engines
on ``cuda``): a 2-replica tier over TCP returns bitwise what one direct
engine returns for the same rows in the same order, the tier's requests
riding buckets 1-8 of the default ladder and the direct engine's rows one
bucket of 32 (the serving programs' row-invariant ops make a row's bits
independent of its bucket), and a large-k ``score`` routed to
the sharded replica launches B1 ``ceil(k / k_chunk)`` times per dispatch.
Small widths whose output block the kernels take; the flagship runs in
chip_smoke.py's tier phase.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_frontend_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.ops import hot_loop
from iwae_replication_project_tpu_torch.serving.buckets import BucketLadder
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.frontend import (
    ServingTier,
    TierClient,
)
from iwae_replication_project_tpu_torch.serving.sharded import (
    ShardedScoreEngine,
)

KC = 250
K = 50
CFG = ModelConfig(n_hidden_enc=(64,), n_latent_enc=(16,), n_hidden_dec=(64,),
                  n_latent_dec=(784,), likelihood="logits",
                  compute_dtype="bfloat16")
WAIT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 has no CPU mode (the tier is "
                    "tested on the CPU in test_torch_frontend.py and held "
                    "against the JAX tier in test_torch_tier_parity.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def params():
    return init_params(torch.Generator().manual_seed(2), CFG)


def _fast(params, ladder=None, **kw):
    return ServingEngine(params=params, model_config=CFG, k=K,
                         ladder=ladder, timeout_s=WAIT, **kw)


def _rows(n, seed=0):
    return (np.random.RandomState(seed).rand(n, 784) > 0.5).astype(
        np.float32)


@pytest.mark.cuda
def test_two_replica_tier_is_bitwise_one_direct_engine(cuda, params):
    x = _rows(17)
    direct = _fast(params)
    want = direct.score(x)
    hot_loop.reset_launch_counts()
    tier = ServingTier([_fast(params), _fast(params)],
                       monitor_interval_s=0.05)
    tier.warmup(ops=("score",))
    tier.start()
    try:
        with TierClient("127.0.0.1", tier.port, timeout_s=WAIT) as c:
            got, i = [], 0
            for n in (1, 3, 7, 2, 4):
                got.extend(c.score(x[i:i + n].tolist()))
                i += n
    finally:
        tier.stop(timeout_s=30)
    assert np.array_equal(np.asarray(got, np.float32), want)
    assert hot_loop.launch_counts()[hot_loop.KERNEL] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [300, 1000])
def test_large_k_goes_to_the_sharded_replica_one_b1_per_block(cuda, params,
                                                              k):
    big = ShardedScoreEngine(params=params, model_config=CFG, k=K,
                             k_chunk=KC, k_max=1000, max_batch=8,
                             timeout_s=WAIT)
    tier = ServingTier([_fast(params, BucketLadder((8,))), big],
                       large_k_threshold=256,
                       monitor_interval_s=0.05)
    tier.warmup(ops=("score",))
    tier.start()
    log = []
    launch = big._launch

    def recording(batch):
        inf = launch(batch)
        log.append(inf)
        return inf
    big._launch = recording
    try:
        torch.cuda.synchronize()
        hot_loop.reset_launch_counts()
        with TierClient("127.0.0.1", tier.port, timeout_s=WAIT) as c:
            out = c.score(_rows(3, 1).tolist(), k=k)
        torch.cuda.synchronize()
        launches = hot_loop.launch_counts()[hot_loop.KERNEL]
    finally:
        tier.stop(timeout_s=30)
    assert np.isfinite(out).all() and len(out) == 3
    assert log and all(inf.k == k for inf in log)
    assert launches == len(log) * -(-k // KC)

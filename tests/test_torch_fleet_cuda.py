"""The executable store's CUDA graphs and the fleet's warm join on the card
(utils/compile_cache.py, serving/engine.py, serving/fleet/): every bucket's
replayed graph is bitwise its eager program, an evicted program readmits by
re-capture with no kernel build, and a replica joining over resident
programs captures nothing. Small widths whose output block the kernels
take; the flagship runs in chip_smoke.py's phase 12.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleet_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.ops import hot_loop
from iwae_replication_project_tpu_torch.serving import programs
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.fleet import FleetManager
from iwae_replication_project_tpu_torch.serving.frontend import ServingTier
from iwae_replication_project_tpu_torch.utils import compile_cache as cc

K = 50
CFG = ModelConfig(n_hidden_enc=(64, 32), n_latent_enc=(16, 8),
                  n_hidden_dec=(32, 64), n_latent_dec=(16, 784),
                  likelihood="logits", compute_dtype="bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the store captures CUDA graphs "
                    "only on the card (its bookkeeping is tested on the "
                    "CPU in test_torch_store.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def params():
    return init_params(torch.Generator().manual_seed(4), CFG)


def _engine(params, **kw):
    return ServingEngine(params=params, model_config=CFG, k=K, max_batch=16,
                         timeout_s=60.0, **kw)


def _rows(n, d=784, seed=0):
    return (np.random.RandomState(seed).rand(n, d) > 0.5).astype(np.float32)


def _serve(eng, op, x, started=False):
    """`x`'s rows as one batch, row i with seed i."""
    futs = [eng.submit(op, row, seed=i) for i, row in enumerate(x)]
    if not started:
        eng.flush()
    return np.stack([f.result(timeout=60) for f in futs])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_every_bucket_graph_is_bitwise_its_eager_program(cuda, params,
                                                         precision):
    with cc.isolated_aot_registry(budget_bytes=None):
        eng = _engine(params, precision=precision)
        warm = eng.warmup()
        assert warm["captures"] == 3 * len(eng.ladder.buckets)
        for op in ("score", "encode", "decode"):
            d = eng.row_dims[op]
            for bucket in eng.ladder.buckets:
                x = _rows(bucket, d, seed=bucket) if op != "decode" else \
                    np.random.RandomState(bucket).randn(bucket, d).astype(
                        np.float32)
                got = _serve(eng, op, x)
                cfg, _ = eng._kernel_for(op, K if op != "decode" else 0,
                                         bucket)
                fn, takes_k = programs.PROGRAMS[op]
                args = (eng._params, cfg, 0, list(range(len(x))),
                        torch.from_numpy(x).cuda()) + \
                    ((K,) if takes_k else ())
                want = fn(*args).cpu().numpy()
                assert np.array_equal(got, want), (op, bucket)
        assert all(e["pool_bytes"] > 0 for e in
                   cc.executable_store().entries())


@pytest.mark.cuda
def test_evict_readmit_recaptures_with_no_kernel_build(cuda, params):
    with cc.isolated_aot_registry(budget_bytes=None):
        eng = _engine(params)
        eng.warmup(ops=("score",))
        x = _rows(3)
        first = _serve(eng, "score", x)
        store = cc.executable_store()
        s0 = cc.cache_stats()
        store.set_budget(0)          # evicts every unpinned entry
        assert len(store) == 0
        store.set_budget(None)
        again = _serve(eng, "score", x)
        d = cc.stats_delta(s0)
        assert np.array_equal(first, again)
        assert d["store_evictions"] == len(eng.ladder.buckets)
        assert d["store_readmits"] == 1 and d["aot_captures"] == 1
        assert d["aot_warmups"] == 0 and d["kernel_builds"] == 0


@pytest.mark.cuda
def test_warm_join_captures_nothing_and_matches(cuda, params):
    with cc.isolated_aot_registry(budget_bytes=None):
        first = _engine(params, model="m")
        tier = ServingTier([first], monitor_interval_s=0.05)
        tier.warmup(ops=("score",))
        tier.start()
        try:
            fleet = FleetManager(
                tier, lambda: ServingEngine(
                    params=first._params, model_config=first.cfg, k=K,
                    max_batch=16, timeout_s=60.0, model="m"),
                warmup_ops=("score",))
            s0 = cc.cache_stats()
            hot_loop.reset_launch_counts()
            idx = fleet.scale_up()
            d = cc.stats_delta(s0)
            assert d["aot_captures"] == 0 and d["kernel_builds"] == 0
            assert d["store_misses"] == 0
            assert hot_loop.launch_counts()[hot_loop.KERNEL] == 0
            joined = tier.router.engines[idx]
            x = _rows(5, seed=7)
            got = _serve(joined, "score", x, started=True)
            want = _serve(first, "score", x, started=True)
            assert np.array_equal(got, want)
        finally:
            tier.stop(timeout_s=30)

"""A served row's bits on the CPU do not depend on its bucket.

The JAX serving programs give a row bitwise the same result at any batch
size (JAX ``serving/programs.py:1-11``). The port's serving programs take
``ops/row_invariant``'s dense layers and sums on every device
(``ops/hot_loop.serving_dispatch_config``); on the CPU those are the
kernels' in-order plain versions. Here every row of 64 is served in every
bucket from 1 to 64, at every position a rotation puts it in, and held bit
for bit against the row served alone: through the three programs of a
tiny model, through one full-width dense layer (784 x 200) and the sums
the score program runs, and through an engine whose batcher coalesces
ragged requests.
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.ops import row_invariant as ri
from iwae_replication_project_tpu_torch.ops.hot_loop import (
    serving_dispatch_config)
from iwae_replication_project_tpu_torch.serving import programs
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine

D = 21  # odd: a call's vector tails fall inside rows
K = 4
ROWS = 64
BUCKETS = range(1, ROWS + 1)
CPU = torch.device("cpu")


def _tiny(compute_dtype=None, likelihood="logits"):
    cfg = model.ModelConfig(x_dim=D, n_hidden_enc=(16, 8),
                            n_latent_enc=(7, 3), n_hidden_dec=(8, 16),
                            n_latent_dec=(7, D), compute_dtype=compute_dtype,
                            likelihood=likelihood)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def _payload(op, n, cfg):
    rng = np.random.RandomState(3)
    if op == "decode":
        return torch.from_numpy(rng.randn(n, cfg.n_latent_enc[-1])
                                .astype(np.float32))
    return torch.from_numpy((rng.rand(n, D) > 0.5).astype(np.float32))


def _every_bucket(fn, n_rows=ROWS):
    """``fn(rows) -> [len(rows), ...]`` for each bucket b in 1..n_rows on
    the rows ``(b + i) % n_rows`` for i < b: returns the rows whose result
    in some bucket differs from the row's result alone, as (row, bucket)."""
    alone = [fn([r])[0] for r in range(n_rows)]
    bad = []
    for b in range(1, n_rows + 1):
        rows = [(b + i) % n_rows for i in range(b)]
        out = fn(rows)
        bad += [(r, b) for i, r in enumerate(rows)
                if not torch.equal(out[i], alone[r])]
    return bad


def test_every_serving_dispatch_config_is_row_invariant_on_the_cpu():
    cfg, _ = _tiny()
    for gated in (True, False):
        out, _ = serving_dispatch_config(cfg, K, 8, device=CPU, gated=gated)
        assert out.row_invariant


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("op,likelihood", [
    ("score", "logits"), ("score", "clamp"), ("encode", "logits"),
    ("decode", "logits")])
def test_tiny_model_rows_are_bitwise_in_every_bucket(op, likelihood, cd):
    """Every row 1-64 in every bucket 1-64 through the program the engine
    serves on the CPU, each row with its own request seed."""
    cfg, params = _tiny(cd, likelihood)
    cfg_d, _ = serving_dispatch_config(cfg, K, ROWS, device=CPU,
                                       gated=op == "score")
    fn, takes_k = programs.PROGRAMS[op]
    payload = _payload(op, ROWS, cfg)

    def serve(rows):
        args = (payload[rows], K) if takes_k else (payload[rows],)
        return fn(params, cfg_d, 7, rows, *args)

    assert _every_bucket(serve) == []


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("tanh", [False, True])
def test_full_width_dense_rows_are_bitwise_in_every_bucket(tanh, cd):
    """The flagship's widest layer, 784 x 200, at every M from 1 to 64."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.rand(ROWS, 784) > 0.5).astype(np.float32))
    w = torch.from_numpy((rng.randn(784, 200) / 28.0).astype(np.float32))
    b = torch.from_numpy((rng.randn(200) * 0.1).astype(np.float32))
    assert _every_bucket(lambda rows: ri.dense(x[rows], w, b, cd, tanh)) \
        == []


def test_full_width_sums_are_bitwise_in_every_bucket():
    """The score program's sums at full width: over 784 pixels per row, and
    over k=50 samples per row."""
    rng = np.random.RandomState(6)
    pix = torch.from_numpy(rng.randn(ROWS, 784).astype(np.float32))
    assert _every_bucket(lambda rows: ri.fixed_sum(pix[rows], -1)) == []
    lw = torch.from_numpy(rng.randn(50, ROWS).astype(np.float32) * 30)
    assert _every_bucket(
        lambda rows: ri.fixed_sum(lw[:, rows], 0)) == []


def test_in_order_dense_stays_within_rounding_of_the_library():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(33, 784).astype(np.float32))
    w = torch.from_numpy((rng.randn(784, 200) / 28.0).astype(np.float32))
    b = torch.zeros(200)
    np.testing.assert_allclose(ri.dense(x, w, b).numpy(),
                               ri.dense_plain(x, w, b).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_engine_rows_coalesced_in_any_batch_equal_the_rows_alone():
    """An engine whose batcher coalesces ragged requests (max batch 16):
    each request's rows bitwise the same rows scored one at a time."""
    cfg, params = _tiny()
    x = _payload("score", 24, cfg).numpy()
    eng = ServingEngine(params=params, model_config=cfg, k=K, max_batch=16,
                        max_inflight=2, timeout_s=30.0, device="cpu").start()
    try:
        futures, lo = [], 0
        for n in (1, 3, 2, 4, 7, 5, 2):
            futures.append((lo, [eng.submit("score", x[lo + i], seed=lo + i)
                                 for i in range(n)]))
            lo += n
        got = np.concatenate([[f.result(timeout=30) for f in fs]
                              for _, fs in futures])
        coalesced = int(eng.metrics.counters()["dispatches"])
        alone = np.array([eng.submit("score", x[i], seed=i).result(timeout=30)
                          for i in range(lo)])
    finally:
        eng.stop()
    assert coalesced < lo  # some dispatch carried several rows
    np.testing.assert_array_equal(got, alone)
    assert got.dtype == alone.dtype and np.isfinite(got).all()


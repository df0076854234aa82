"""Online serving (port of ``serving/``): micro-batching engine, bucket
ladder, row-independent programs, metrics, the mesh-sharded large-k engine
with ``score_adaptive``, the fault sites, and the TCP tier in
``serving.frontend``."""

from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
    RequestTimeout,
)
from iwae_replication_project_tpu_torch.serving.buckets import (
    BucketLadder,
    KChunkMenu,
    target_class,
    validate_adaptive_target,
    validate_k,
)
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_ENGINE_FETCH,
    SITE_ENGINE_LAUNCH,
    crash_replica,
    slow_replica,
)
from iwae_replication_project_tpu_torch.serving.sharded import (
    ShardedScoreEngine,
    default_sharded_ladder,
    serve_rank,
)

__all__ = [
    "BucketLadder",
    "EngineOverloaded",
    "KChunkMenu",
    "RequestTimeout",
    "SITE_ENGINE_FETCH",
    "SITE_ENGINE_LAUNCH",
    "ServingEngine",
    "ShardedScoreEngine",
    "crash_replica",
    "default_sharded_ladder",
    "serve_rank",
    "slow_replica",
    "target_class",
    "validate_adaptive_target",
    "validate_k",
]

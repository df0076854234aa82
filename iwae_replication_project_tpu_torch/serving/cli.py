"""The serving CLI (port of ``serving/cli.py``).

    python -m iwae_replication_project_tpu_torch.serving \\
        [--preset NAME | --checkpoint RUN_DIR | --models A,B,...]
        [--interactive] [--device cpu] [--store-budget-mb MB]
        [--replicas N [--sharded-replicas M] [--port P] [--autoscale ...]]
        [--client HOST:PORT [--k-sweep K1,K2] [--target-se SE]]

One program, three roles:

* **in-process engine** (no ``--replicas``/``--client``): builds one engine
  (on ``cuda`` unless ``--device cpu``) from a driver checkpoint run
  directory (``--checkpoint``, ``<checkpoint_dir>/<run_name>``: the trained
  weights, served at the run's k unless ``--k``) or with fresh weights of a
  zoo preset (``--preset``, default the flagship), warms its bucket ladder
  and prints one JSON line (warmup, buckets, k), then runs a synthetic
  ragged load and prints one JSON summary (with ``--log-dir`` also stamped
  as JSONL), or with ``--interactive`` serves JSON lines from stdin
  (``{"op": "score", "x": [[...pixels...]], "k": 50}``), one result line
  each, until EOF;
* **serving tier** (``--replicas N``): N engines over the one set of
  weights, plus ``--sharded-replicas M`` large-k engines
  (``ShardedScoreEngine`` over a world of one, mesh (1, 1)), behind the TCP
  front end (``serving/frontend/``). ``score`` requests with k above
  ``--k-threshold`` go to the sharded replicas, whose ``--k-max`` bounds
  them. With ``--models A,B,...`` the tier is multi-model: one (or
  ``--replicas``) model-labeled replica(s) per zoo preset
  (``zoo.serving_engines``), requests picking their model with the wire's
  ``model`` field (the first name is the default), the process executable
  store bounding the programs of all of them (``--store-budget-mb``: LRU
  eviction, readmission by re-capture without a kernel build).
  ``--autoscale`` runs the fleet's control loop (``serving/fleet/``): it
  reads the tier's burn rates and scales the fast replicas between
  ``--autoscale-min`` and ``--autoscale-max``, joining warm over the
  resident programs and leaving by drain. Prints a ready line with the
  bound port, serves until stdin EOF, then drains and prints the router's
  final counters (and the fleet's decision log): hold stdin open when
  backgrounding it;
* **tier client** (``--client HOST:PORT``): drives a running tier over TCP
  (of this package or of the JAX package: the wire is the same), a
  synthetic ragged load by default, ``--k-sweep`` for a score (or, with
  ``--target-se``/``--ess-floor``, ``score_adaptive``) sweep over k, or
  ``--interactive`` to forward JSON lines from stdin.

``--metrics-port P`` (engine and tier modes; 0 = an ephemeral port,
printed as ``metrics_port`` in the warm-up line) serves the metrics page at
``http://127.0.0.1:P/metrics`` with ``/traces``, ``/prof`` and ``/healthz``
(telemetry/exporters.py). In tier mode the page holds the process registry
and the tier's (router and SLO families; the replicas' engine registries
are left out, their names would collide), ``/traces`` the tier's flight
recorder, ``/prof`` one document per replica engine, ``/healthz`` 503 once
no replica is healthy. In engine mode it holds the process registry and the
engine's (``serve/*`` spans, ``prof/*``), ``/prof`` the engine's profiler.

The JAX CLI's ``--pin-core`` and the int8 precision policy (ROADMAP A8b)
are refused with the reason; its per-model ``--precision model=policy``
pairs are not ported (one policy serves every model).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
)
from iwae_replication_project_tpu_torch.serving.buckets import BucketLadder
from iwae_replication_project_tpu_torch.utils.config import _refused

#: the JAX CLI's flags of parts the port lacks -> (reason, takes a value)
REFUSED = {
    "--pin-core": ("the port runs on the card, not one pinned CPU core",
                   True),
}


def _precision(spec: str) -> str:
    if spec == "int8":
        raise argparse.ArgumentTypeError(
            "int8 is not ported yet: it waits for the serving_int8 autotune "
            "gate (ROADMAP A9 with A8)")
    if spec not in ("fp32", "bf16"):
        raise argparse.ArgumentTypeError(f"unknown precision {spec!r}; "
                                         f"expected fp32 or bf16")
    return spec


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.serving",
        description="IWAE serving on PyTorch/CUDA: one in-process engine "
                    "under synthetic ragged load or JSON lines on stdin")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--checkpoint", default=None,
                     help="driver checkpoint run directory "
                          "(<checkpoint_dir>/<run_name>)")
    src.add_argument("--preset", default=None,
                     help="zoo preset naming the architecture (fresh, "
                          "untrained weights; default: the flagship "
                          "northstar-iwae-2l-k50)")
    src.add_argument("--models", default=None, metavar="NAME1,NAME2,...",
                     help="multi-model tier: several zoo presets behind one "
                          "endpoint (fresh weights each; requests pick one "
                          "with the wire's 'model' field, the first is the "
                          "default). Implies the tier mode; --replicas N "
                          "runs N replicas per model (default 1)")
    ap.add_argument("--store-budget-mb", dest="store_budget_mb", type=float,
                    default=None,
                    help="device-memory budget (MiB) of the process "
                         "executable store: past it the least recently "
                         "used programs are evicted and re-captured on "
                         "demand, with no kernel build (omit: unbounded)")
    ap.add_argument("--interactive", action="store_true",
                    help="serve JSON-lines requests from stdin instead of "
                         "synthetic load")
    ap.add_argument("--requests", type=int, default=200,
                    help="synthetic load: request batches to submit (each "
                         "of one of --sizes rows)")
    ap.add_argument("--sizes", default="1,3,7,17",
                    help="synthetic load: cycle of ragged batch sizes")
    ap.add_argument("--ops", default="score,encode,decode",
                    help="comma-separated ops to warm and cycle through")
    ap.add_argument("--k", type=int, default=None,
                    help="importance samples per score/encode request "
                         "(default: the preset's or checkpoint's k)")
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=64)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated explicit bucket ladder (e.g. '32' "
                         "pads every dispatch to one shape); default: "
                         "powers of two up to --max-batch")
    ap.add_argument("--max-wait-us", dest="max_wait_us", type=float,
                    default=2000.0)
    ap.add_argument("--queue-limit", dest="queue_limit", type=int,
                    default=1024)
    ap.add_argument("--max-inflight", dest="max_inflight", type=int,
                    default=2,
                    help="launched but uncompleted batches; 0 = serial")
    ap.add_argument("--timeout-s", dest="timeout_s", type=float, default=2.0,
                    help="per-request queue deadline; <= 0 disables")
    ap.add_argument("--kernel-path", dest="kernel_path", default=None,
                    choices=["kernel", "reference"])
    ap.add_argument("--precision", default=None, type=_precision,
                    help="fp32 | bf16 (int8 is not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", dest="log_dir", default=None,
                    help="also stamp the final metrics as JSONL under this "
                         "directory (utils/logging.MetricsLogger)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--metrics-port", dest="metrics_port", type=int,
                    default=None,
                    help="serve the metrics page (/metrics, /traces, /prof, "
                         "/healthz) at http://127.0.0.1:PORT (0 = an "
                         "ephemeral port, printed in the warm-up line; omit "
                         "= off)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="client mode's synthetic load: offered request "
                         "batches a second (0 = as fast as it can send)")
    tier = ap.add_argument_group("serving tier (serving/frontend/)")
    tier.add_argument("--replicas", type=int, default=0,
                      help="run the TCP tier with N engine replicas over "
                           "one set of weights (0 = the in-process modes)")
    tier.add_argument("--port", type=int, default=0,
                      help="tier TCP port (0 = ephemeral, printed in the "
                           "ready line)")
    tier.add_argument("--host", default="127.0.0.1")
    tier.add_argument("--max-outstanding", dest="max_outstanding", type=int,
                      default=4096,
                      help="tier-wide admission ceiling (outstanding "
                           "requests) before typed 'overloaded' rejections")
    tier.add_argument("--no-tracing", dest="tracing", action="store_false",
                      default=True,
                      help="disable request tracing (on by default: every "
                           "request's spans land in the flight recorder "
                           "the 'traces' wire op dumps; results are "
                           "bitwise the same either way)")
    tier.add_argument("--sharded-replicas", dest="sharded_replicas",
                      type=int, default=0,
                      help="also run N large-k score replicas "
                           "(ShardedScoreEngine over the same weights): "
                           "score requests with k above --k-threshold go "
                           "to them")
    tier.add_argument("--k-chunk", dest="k_chunk", type=int, default=250,
                      help="sharded replicas: the sample block (it "
                           "versions the sample stream)")
    tier.add_argument("--k-max", dest="k_max", type=int, default=5000,
                      help="sharded replicas: per-request k admission bound")
    tier.add_argument("--k-threshold", dest="k_threshold", type=int,
                      default=None,
                      help="route score requests with k above this to the "
                           "sharded replicas; also the fast replicas' k_max "
                           "(default: the engine's default bound, or "
                           "--k-max/2 when --k-max is at or below it)")
    tier.add_argument("--mesh-dp", dest="mesh_dp", type=int, default=1,
                      help="sharded replicas' data-parallel axis; the CLI "
                           "serves a world of one process, so only 1")
    tier.add_argument("--mesh-sp", dest="mesh_sp", type=int, default=None,
                      help="sharded replicas' sample-parallel axis "
                           "(default: the world, one process)")
    tier.add_argument("--quota-rate", dest="quota_rate", type=float,
                      default=None,
                      help="per-client token-bucket refill (rows a second); "
                           "omit = quotas off")
    tier.add_argument("--quota-burst", dest="quota_burst", type=float,
                      default=None,
                      help="per-client bucket capacity in rows (default 10x "
                           "--quota-rate)")
    scale = ap.add_argument_group(
        "elastic fleet (serving/fleet/; needs --replicas or --models)")
    scale.add_argument("--autoscale", action="store_true",
                       help="run the SLO-driven autoscaler: a control "
                            "thread reads the tier's burn rates and scales "
                            "the fast-replica count between --autoscale-min "
                            "and --autoscale-max (scale-up joins warm over "
                            "the resident programs, scale-down drains: no "
                            "accepted request is lost and results stay "
                            "bitwise those of a fixed fleet)")
    scale.add_argument("--autoscale-min", dest="autoscale_min", type=int,
                       default=1, help="lower replica bound (default 1)")
    scale.add_argument("--autoscale-max", dest="autoscale_max", type=int,
                       default=None,
                       help="upper replica bound (default: 2x --replicas)")
    scale.add_argument("--autoscale-up-burn", dest="autoscale_up_burn",
                       type=float, default=1.0,
                       help="fast-window worst burn rate at or above which "
                            "the fleet grows (default 1.0)")
    scale.add_argument("--autoscale-down-burn", dest="autoscale_down_burn",
                       type=float, default=0.25,
                       help="fast-window burn at or below which an idle "
                            "fleet shrinks; the gap up to "
                            "--autoscale-up-burn is the hysteresis band")
    scale.add_argument("--autoscale-up-cooldown-s",
                       dest="autoscale_up_cooldown_s", type=float,
                       default=30.0, help="minimum seconds between "
                                          "scale-ups")
    scale.add_argument("--autoscale-down-cooldown-s",
                       dest="autoscale_down_cooldown_s", type=float,
                       default=120.0,
                       help="minimum seconds from the last scale event (in "
                            "either direction) to a scale-down")
    scale.add_argument("--autoscale-interval-s",
                       dest="autoscale_interval_s", type=float, default=1.0,
                       help="control-loop tick period")
    scale.add_argument("--autoscale-dry-run", dest="autoscale_dry_run",
                       action="store_true",
                       help="evaluate and log every scaling decision but "
                            "never act on one")
    tier.add_argument("--client", default=None, metavar="HOST:PORT",
                      help="client mode: drive a running tier over TCP")
    tier.add_argument("--client-id", dest="client_id", default=None,
                      help="client mode: the quota principal of requests")
    tier.add_argument("--model", default=None,
                      help="client mode: the tenant model stamped on every "
                           "request (omit = the tier's default model)")
    tier.add_argument("--retries", type=int, default=0,
                      help="client mode: retries per request after the "
                           "first attempt (0 = the one-shot client)")
    tier.add_argument("--hedge-after-s", dest="hedge_after_s", type=float,
                      default=None,
                      help="client mode: re-send a request unanswered after "
                           "this many seconds on a second connection, first "
                           "response wins (needs --retries >= 1)")
    tier.add_argument("--retry-deadline-s", dest="retry_deadline_s",
                      type=float, default=30.0,
                      help="client mode: wall budget per request across "
                           "retries and hedges")
    tier.add_argument("--k-sweep", dest="k_sweep", default=None,
                      metavar="K1,K2,...",
                      help="client mode: score load cycling the request k "
                           "through these values; per-k latency")
    tier.add_argument("--target-se", dest="target_se", type=float,
                      default=None,
                      help="client mode: drive score_adaptive with this "
                           "target standard error (with --k-sweep the "
                           "values become sample caps)")
    tier.add_argument("--ess-floor", dest="ess_floor", type=float,
                      default=None,
                      help="client mode: score_adaptive's ESS floor")
    for flag, (why, takes_value) in REFUSED.items():
        ap.add_argument(flag, action=_refused(why, takes_value),
                        help=argparse.SUPPRESS)
    return ap


def _engine_knobs(args) -> dict:
    """The engine keywords every construction path shares."""
    ladder = BucketLadder(tuple(int(s) for s in args.buckets.split(",")
                                if s)) if args.buckets else None
    return dict(device=args.device, max_batch=args.max_batch, ladder=ladder,
                max_wait_us=args.max_wait_us, queue_limit=args.queue_limit,
                max_inflight=args.max_inflight,
                timeout_s=args.timeout_s if args.timeout_s > 0 else None,
                kernel_path=args.kernel_path, seed=args.seed)


def build_engine(args):
    """The engine the arguments describe."""
    knobs = dict(_engine_knobs(args), k=args.k, precision=args.precision)
    if args.checkpoint:
        return zoo.serving_engine(checkpoint_dir=args.checkpoint, **knobs)
    return zoo.serving_engine(args.preset or "northstar-iwae-2l-k50",
                              **knobs)


def _k_split(args):
    """The mixed tier's (fast k_max, routing threshold): the two classes
    tile ``[1, --k-max]`` -- fast replicas up to the threshold, sharded
    ones above it. Without ``--k-threshold`` the split sits at the engine's
    default bound, or at half of ``--k-max`` when the whole range fits
    under it."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        DEFAULT_K_MAX)

    if args.sharded_replicas <= 0:
        return None, args.k_threshold
    t = args.k_threshold
    if t is None:
        t = DEFAULT_K_MAX if DEFAULT_K_MAX < args.k_max \
            else max(1, args.k_max // 2)
    if not 1 <= t < args.k_max:
        raise SystemExit(f"--k-threshold {t} must be in [1, --k-max "
                         f"{args.k_max}) when --sharded-replicas is set")
    return t, t


def _check_mesh(ap, args) -> None:
    """The sharded replicas run over a world of one process (mesh (1, 1)):
    a larger mesh is an argparse error that says why."""
    sp = 1 if args.mesh_sp is None else args.mesh_sp
    if args.mesh_dp < 1 or sp < 1:
        ap.error(f"--mesh-dp/--mesh-sp must be >= 1, got {args.mesh_dp}/"
                 f"{sp}")
    if args.mesh_dp * sp > 1:
        ap.error(f"--mesh-dp {args.mesh_dp} --mesh-sp {sp}: the serving "
                 f"CLI's sharded replicas run over a world of one process, "
                 f"mesh (1, 1); a larger mesh needs one process per rank "
                 f"(serving.sharded.serve_rank on the others), which this "
                 f"CLI does not start")


def _sharded_engines(args, sources):
    """``--sharded-replicas`` large-k engines per ``(model label, engine)``
    of `sources`, over that engine's weights, each a world of one (mesh
    (1, 1) on the replicas' device): the one construction of the
    single-model and the ``--models`` tiers."""
    from iwae_replication_project_tpu_torch.parallel.mesh import make_mesh
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)

    knobs = _engine_knobs(args)
    knobs.pop("ladder")  # the sharded ladder is the engine's own
    knobs.pop("device")  # the mesh's
    return [ShardedScoreEngine(
        params=first._params, model_config=first.cfg, k=min(first.k,
                                                            args.k_max),
        mesh=make_mesh(dp=args.mesh_dp, sp=args.mesh_sp or 1,
                       device=first.device),
        k_chunk=args.k_chunk, k_max=args.k_max,
        precision=first.precision, model=label, **knobs)
        for label, first in sources
        for _ in range(args.sharded_replicas)]


def build_replicas(args, n: int) -> list:
    """N fast engines (plus the ``--sharded-replicas``) over ONE set of
    weights: the first engine resolves the checkpoint or preset, the rest
    share its parameter tensors and config. With ``--models``, N engines
    per preset instead (``zoo.serving_engines``), each model with its own
    sharded replicas over its weights."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)

    fast_k_max, _ = _k_split(args)
    if args.models:
        names = [s for s in args.models.split(",") if s]
        engines = zoo.serving_engines(
            names, replicas_per_model=max(1, n), k=args.k,
            precisions=args.precision, **_engine_knobs(args))
        if fast_k_max is not None:
            for e in engines:       # the k split applies per fast replica
                e.k_max = max(fast_k_max, e.k)
        if args.sharded_replicas > 0:
            engines.extend(_sharded_engines(args, [
                (name, next(e for e in engines if e.model == name))
                for name in names]))
        return engines
    first = build_engine(args)
    if fast_k_max is not None:
        # the fast bound is the threshold, but never below the engine's own
        # default k
        first.k_max = max(fast_k_max, first.k)
    engines = [first]
    for _ in range(1, n):
        engines.append(ServingEngine(
            params=first._params, model_config=first.cfg, k=first.k,
            k_max=first.k_max, precision=first.precision,
            **_engine_knobs(args)))
    if args.sharded_replicas > 0:
        engines.extend(_sharded_engines(args, [(None, first)]))
    return engines


def _fleet(args, tier):
    """``--autoscale``: the fleet manager over the running tier, its
    factory a new fast engine over the first fast replica's weights (so
    its warmup finds every program resident in the store)."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.fleet import (
        AutoscaleConfig, FleetManager)

    first = next(e for e in tier.router.engines
                 if not getattr(e, "sharded", False))

    def factory(first=first, knobs=_engine_knobs(args)):
        return ServingEngine(
            params=first._params, model_config=first.cfg, k=first.k,
            k_max=first.k_max, precision=first.precision,
            model=first.model, **knobs)

    return FleetManager(tier, factory, AutoscaleConfig(
        min_replicas=max(1, args.autoscale_min),
        max_replicas=(args.autoscale_max if args.autoscale_max is not None
                      else max(2 * args.replicas, args.autoscale_min)),
        scale_up_burn=args.autoscale_up_burn,
        scale_down_burn=args.autoscale_down_burn,
        up_cooldown_s=args.autoscale_up_cooldown_s,
        down_cooldown_s=args.autoscale_down_cooldown_s,
        interval_s=args.autoscale_interval_s,
        dry_run=args.autoscale_dry_run, seed=args.seed)).start()


def tier_mode(args, ops) -> int:
    """``--replicas N``: serve the TCP tier until stdin reaches EOF."""
    from iwae_replication_project_tpu_torch.serving.frontend import (
        QuotaPolicy, ServingTier)

    quota = None
    if args.quota_rate is not None:
        quota = QuotaPolicy(rate=args.quota_rate,
                            burst=(args.quota_burst
                                   if args.quota_burst is not None
                                   else 10.0 * args.quota_rate))
    _, threshold = _k_split(args)
    engines = build_replicas(args, args.replicas)
    tier = ServingTier(engines, quota=quota,
                       max_outstanding=args.max_outstanding,
                       host=args.host, port=args.port,
                       large_k_threshold=threshold, tracing=args.tracing)
    warm = tier.warmup(ops=ops)
    tier.start()
    fleet = _fleet(args, tier) if args.autoscale else None
    metrics_srv = None
    if args.metrics_port is not None:
        from iwae_replication_project_tpu_torch.telemetry import (
            get_registry, start_metrics_server)

        def _tier_health():
            states = tier.router.replica_states()
            healthy = sum(1 for st in states if st["healthy"])
            return {"ok": healthy > 0, "replicas": len(states),
                    "healthy": healthy,
                    "outstanding": tier.router.outstanding}

        metrics_srv = start_metrics_server(
            (get_registry(), tier.registry), args.metrics_port,
            recorder=tier.recorder, profilers=tier.router.profilers(),
            health=_tier_health)
    info = tier.info()
    dev = engines[0].device
    print(json.dumps({
        "tier": {"replicas": args.replicas,
                 "sharded_replicas": info["sharded_replicas"],
                 "large_k_threshold": info["large_k_threshold"],
                 "k_max": info["k_max"], "port": tier.port,
                 "host": args.host, "models": sorted(info["models"]),
                 "default_model": info["default_model"],
                 "quota": info["quota"],
                 "autoscale": (dataclasses.asdict(fleet.config)
                               if fleet is not None else None)},
        "warmup": warm, "buckets": info["buckets"], "k": info["k"],
        "metrics_port": (metrics_srv.server_address[1]
                         if metrics_srv is not None else None),
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "source": args.models or args.checkpoint or args.preset
        or "northstar-iwae-2l-k50"}), flush=True)
    try:
        for _ in sys.stdin:     # lifetime control: serve until stdin EOF
            pass
    except KeyboardInterrupt:
        pass
    if fleet is not None:
        fleet.stop()            # the control thread first: no scale event
    tier.stop()                 # may race the tier's drain
    if metrics_srv is not None:
        metrics_srv.shutdown()
    snap = tier.registry.snapshot()
    print(json.dumps({
        "router": {k: v for k, v in snap["counters"].items()
                   if k.startswith("router/")},
        "replicas": tier.router.replica_states(),
        "fleet": fleet.doc() if fleet is not None else None,
        "store": tier.stats()["store"],
        "engines": [e.metrics.snapshot()["counters"]
                    for e in tier.router.engines]}), flush=True)
    return 0


def _client_interactive(cli, lines) -> None:
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req.get("op", "score")
            if op in ("submit_job", "job_status"):
                # the bulk lane's ops answer synchronously, like control ops
                doc = cli._control(op, **{key: req[key] for key in req
                                          if key not in ("op", "id")})
                print(json.dumps({"id": req.get("id"), "ok": True,
                                  "result": doc}), flush=True)
                continue
            rid = cli.submit(op, req["x"], k=req.get("k"),
                             seed=req.get("seed"),
                             target_se=req.get("target_se"),
                             ess_floor=req.get("ess_floor"))
            resp = cli.drain([rid])[rid]
            # the caller correlates on its own id, not the wire id
            resp["id"] = req.get("id")
            print(json.dumps(resp), flush=True)
        except Exception as e:  # a bad request must not end the loop
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  flush=True)


def _client_k_sweep(cli, args) -> int:
    """``--client ... --k-sweep K1,K2,...``: closed-loop score load cycling
    the request k (``score_adaptive`` with the values as caps when a target
    is given), one blocking request at a time so each k gets an honest
    latency sample; typed errors are counted, not fatal."""
    from iwae_replication_project_tpu_torch.serving.frontend.client import (
        TierError)

    info = cli.info()
    adaptive = args.target_se is not None or args.ess_floor is not None
    want_op = "score_adaptive" if adaptive else "score"
    if want_op not in info["row_dims"]:
        print(json.dumps({"error": f"tier does not serve {want_op!r}"}),
              file=sys.stderr, flush=True)
        cli.close()
        return 2
    ks = [int(s) for s in args.k_sweep.split(",") if s]
    dim = info["row_dims"][want_op]
    rng = np.random.RandomState(args.seed)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    walls: dict = {k: [] for k in ks}
    k_used: dict = {k: [] for k in ks}
    errors: dict = {}
    rows_ok = 0
    t0 = time.perf_counter()
    for i in range(args.requests):
        k = ks[i % len(ks)]
        n = sizes[i % len(sizes)]
        batch = (rng.rand(n, dim) > 0.5).astype(np.float32)
        t1 = time.perf_counter()
        try:
            if adaptive:
                out = cli.score_adaptive(batch.tolist(), k=k,
                                         model=args.model,
                                         target_se=args.target_se,
                                         ess_floor=args.ess_floor)
                k_used[k].extend(row[2] for row in out)
            else:
                out = cli.score(batch.tolist(), k=k, model=args.model)
            rows_ok += len(out)
            walls[k].append(time.perf_counter() - t1)
        except TierError as e:
            errors[e.code] = errors.get(e.code, 0) + 1
    wall = time.perf_counter() - t0
    cli.close()
    per_k = {
        str(k): {"requests": len(w),
                 "p50_s": round(float(np.percentile(w, 50)), 6) if w else None,
                 "p95_s": round(float(np.percentile(w, 95)), 6) if w else None}
        for k, w in walls.items()}
    if adaptive:
        for k, used in k_used.items():
            if used:
                per_k[str(k)]["k_used_mean"] = round(float(np.mean(used)), 1)
                per_k[str(k)]["k_used_max"] = int(max(used))
    print(json.dumps({"mode": "client-k-sweep", "target": args.client,
                      "op": want_op, "k_sweep": ks, "per_k": per_k,
                      "ok_rows": rows_ok, "errors": errors,
                      "wall_seconds": round(wall, 3),
                      "info": {key: info[key] for key in
                               ("large_k_threshold", "k_max",
                                "sharded_replicas", "replicas")}}),
          flush=True)
    return 0


def client_mode(args) -> int:
    """``--client HOST:PORT``: drive a running tier over TCP."""
    from iwae_replication_project_tpu_torch.serving.frontend import (
        RetryPolicy, TierClient)

    retry = None
    if args.retries > 0:
        # the flag counts retries; the policy counts attempts
        retry = RetryPolicy(max_attempts=args.retries + 1,
                            deadline_s=args.retry_deadline_s,
                            hedge_after_s=args.hedge_after_s,
                            seed=args.seed)
    host, _, port = args.client.rpartition(":")
    cli = TierClient(host or "127.0.0.1", int(port),
                     client_id=args.client_id, retry=retry)
    if args.interactive:
        _client_interactive(cli, sys.stdin)
        cli.close()
        return 0
    if args.k_sweep:
        return _client_k_sweep(cli, args)
    info = cli.info()
    ops = [s for s in args.ops.split(",") if s and s in info["row_dims"]]
    if not ops:
        print(json.dumps({"error": f"none of the requested ops "
                                   f"({args.ops}) is served by this tier; "
                                   f"it serves {sorted(info['row_dims'])}"}),
              file=sys.stderr, flush=True)
        cli.close()
        return 2
    sizes = [int(s) for s in args.sizes.split(",") if s]
    rng = np.random.RandomState(args.seed)
    dims = info["row_dims"]
    ids = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        op = ops[i % len(ops)]
        n = sizes[i % len(sizes)]
        batch = (rng.rand(n, dims[op]) > 0.5).astype(np.float32) \
            if op != "decode" else rng.randn(n, dims[op]).astype(np.float32)
        ids.append((cli.submit(op, batch.tolist(), model=args.model), n))
        if args.rate > 0:
            time.sleep(rng.exponential(1.0 / args.rate))
    responses = cli.drain([rid for rid, _ in ids])
    wall = time.perf_counter() - t0
    cli.close()
    ok_rows = sum(n for rid, n in ids if responses[rid].get("ok"))
    errors: dict = {}
    for rid, _ in ids:
        r = responses[rid]
        if not r.get("ok"):
            errors[r.get("error", "internal")] = \
                errors.get(r.get("error", "internal"), 0) + 1
    print(json.dumps({"mode": "client", "target": args.client,
                      "requests": args.requests, "ok_rows": ok_rows,
                      "errors": errors, "wall_seconds": round(wall, 3),
                      "rows_per_sec": round(ok_rows / wall, 2)
                      if wall else None,
                      "info": info}), flush=True)
    return 0


def synthetic_load(eng, ops, requests: int, sizes, seed: int) -> dict:
    """Open-loop ragged request stream; returns the final snapshot with wall
    time and throughput."""
    rng = np.random.RandomState(seed)
    eng.start()
    futures = []
    t0 = time.perf_counter()
    for i in range(requests):
        op = ops[i % len(ops)]
        n = sizes[i % len(sizes)]
        d = eng.row_dims[op]
        batch = (rng.rand(n, d) > 0.5).astype(np.float32) \
            if op != "decode" else rng.randn(n, d).astype(np.float32)
        for row in batch:
            try:
                futures.append(eng.submit(op, row))
            except EngineOverloaded:
                pass  # counted by the engine as shed
    failed = 0
    for f in futures:
        if f.exception() is not None:
            failed += 1   # timeouts/errors are counted in the snapshot too
    wall = time.perf_counter() - t0
    eng.stop()
    snap = eng.metrics.snapshot()
    snap["wall_seconds"] = wall
    snap["failed"] = failed
    snap["throughput_rows_per_sec"] = \
        snap["counters"]["completed"] / wall if wall else None
    return snap


def interactive(eng, lines) -> int:
    """Serve JSON-lines requests from `lines`, one JSON result line each
    on standard output; returns the number of error lines."""
    ops = {"score": eng.score, "encode": eng.encode, "decode": eng.decode}
    errors = 0
    eng.start()
    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                op = req.get("op", "score")
                if op not in ops:
                    raise ValueError(f"unknown op {op!r}; choose "
                                     f"{sorted(ops)}")
                kw = {"k": req["k"]} if "k" in req and op != "decode" \
                    else {}
                res = ops[op](req["x"], **kw)
                print(json.dumps({"op": op, "result": res.tolist()}),
                      flush=True)
            except Exception as e:  # a bad request must not end the loop
                errors += 1
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                      flush=True)
    finally:
        eng.stop()
    return errors


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.client:
        return client_mode(args)
    _check_mesh(ap, args)
    if args.store_budget_mb is not None:
        if args.store_budget_mb < 0:
            ap.error(f"--store-budget-mb {args.store_budget_mb} must be >= "
                     f"0 (omit the flag for unbounded)")
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            set_store_budget)
        set_store_budget(int(args.store_budget_mb * 2 ** 20))
    if args.models and args.replicas <= 0:
        args.replicas = 1       # --models is the tier: one replica per model
    if args.autoscale and args.replicas <= 0:
        ap.error("--autoscale scales a tier: pass --replicas N (or "
                 "--models)")
    ops = tuple(s for s in args.ops.split(",") if s)
    if args.replicas > 0:
        return tier_mode(args, ops)
    eng = build_engine(args)
    warm = eng.warmup(ops=ops)
    device = (torch.cuda.get_device_name(eng.device)
              if eng.device.type == "cuda" else "cpu")
    metrics_srv = None
    if args.metrics_port is not None:
        from iwae_replication_project_tpu_torch.telemetry import (
            get_registry, start_metrics_server)
        metrics_srv = start_metrics_server(
            (get_registry(), eng.metrics.registry), args.metrics_port,
            profilers=(eng.profiler,) if eng.profiler is not None else (),
            health=lambda: {"ok": True, "mode": "engine", "ops": list(ops)})
    print(json.dumps({"warmup": warm, "buckets": list(eng.ladder.buckets),
                      "k": eng.k, "device": device,
                      "metrics_port": (metrics_srv.server_address[1]
                                       if metrics_srv is not None else None),
                      "source": args.checkpoint or args.preset
                      or "northstar-iwae-2l-k50"}), flush=True)
    try:
        return _engine_mode(eng, args, ops, warm, device)
    finally:
        if metrics_srv is not None:
            metrics_srv.shutdown()


def _engine_mode(eng, args, ops, warm, device) -> int:
    """The in-process engine's run after its warm-up line: stdin's JSON
    lines, or the synthetic load and its summary."""
    if args.interactive:
        interactive(eng, sys.stdin)
        return 0
    sizes = [int(s) for s in args.sizes.split(",") if s]
    snap = synthetic_load(eng, ops, args.requests, sizes, args.seed)
    snap["warmup"] = warm
    snap["preset"] = args.preset
    snap["checkpoint"] = args.checkpoint
    snap["k"] = eng.k
    snap["buckets"] = list(eng.ladder.buckets)
    snap["device"] = device
    print(json.dumps(snap), flush=True)
    if args.log_dir:
        from iwae_replication_project_tpu_torch.utils.logging import (
            MetricsLogger)
        logger = MetricsLogger(args.log_dir, run_name="serving",
                               tensorboard=False)
        logger.log_registry(eng.metrics.registry,
                            step=int(snap["counters"]["dispatches"]))
        logger.close()
    return 0 if snap["failed"] == 0 else 1

"""The bulk offline lane: dataset-sized scoring jobs below interactive
traffic (port of ``serving/frontend/jobs.py``).

A *job* is one wire document (``{"op": "submit_job", ...}``) naming an
entire dataset to score — thousands of rows through ``score`` or
``score_adaptive`` — that would be abusive as interactive traffic: the
tier's admission ceiling exists to bound interactive latency, and a client
that pumped 50k rows through it would starve every latency-sensitive
request behind its queue. The job lane inverts the priority:

* **background admission** — the manager's pump thread submits job rows
  through the SAME router as interactive traffic, but only while the
  tier-wide outstanding count sits below a configured ``headroom`` (a
  fraction of ``max_outstanding``). Interactive requests go straight to
  the router and push the count up; the pump then stops submitting until
  the burst drains. Bulk work harvests idle fleet capacity and yields it
  back within one small chunk.
* **existing quota machinery** — every submitted chunk is admitted through
  the tier's per-(client, model) token buckets first, so a tenant's bulk
  job spends the same budget as its interactive traffic would
  (``QuotaExceeded`` pauses the pump for the refill interval; it never
  fails the job).
* **deterministic rows** — row ``i`` is submitted with seed
  ``(job_seed + i) mod 2**31``, so each row's result is a pure function of
  (weights, row, job_seed, i, k, targets) — bitwise independent of pump
  pacing, chunk boundaries, routing, and of how often the job was
  interrupted (the serving determinism contract, extended to jobs).
* **checkpoint + resume** — every ``checkpoint_every`` completed-prefix
  rows the pump writes ``<dir>/<n>/progress.json`` (the completed prefix
  of results) and seals it with the training checkpoints' integrity
  manifests (the port's :func:`~...utils.checkpoint.write_manifest`);
  resubmitting the same job doc with ``"resume": true`` verifies the
  newest intact step (:func:`verify_checkpoint` — a truncated/corrupt step
  falls back to the previous one), restores its prefix WITHOUT resubmitting those rows, and
  continues; per-row seed determinism makes the resumed tail bitwise equal
  the uninterrupted run. A resume against a checkpoint written by a
  *different* job doc (other op/k/targets/seed/payload) is a typed
  ``bad_request`` — never a silent splice of two datasets.

``{"op": "job_status", "job": "<id>"}`` is the typed status op: state,
row counts, checkpoint progress, the first row error if any, and — with
``"results": true`` — the per-row results collected so far.

This module is transport-side plumbing like server.py: no torch/numpy at
import time (the manifest helpers are imported when a checkpoint is
written), exercisable with fake engines over localhost sockets.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from iwae_replication_project_tpu_torch.serving.buckets import (
    validate_adaptive_target,
    validate_k,
)
from iwae_replication_project_tpu_torch.serving.frontend.quotas import (
    QuotaExceeded,
)

__all__ = ["BulkJobManager", "BulkJob"]


def _rows_digest(rows: List[Any]) -> str:
    """Identity of a job's payload for the resume-mismatch guard (the
    checkpoint stores this digest, never the rows themselves)."""
    h = hashlib.sha256()
    h.update(json.dumps(rows, separators=(",", ":")).encode("utf-8"))
    return h.hexdigest()


class BulkJob:
    """One admitted bulk job's mutable state (guarded by the manager's
    lock). ``identity`` is the canonical doc the resume guard compares —
    everything that determines the results bitwise."""

    __slots__ = ("job_id", "op", "rows", "k", "target_se", "ess_floor",
                 "seed", "model", "client", "ckpt_dir", "ckpt_every",
                 "state", "results", "next_row", "completed", "prefix",
                 "checkpointed", "error", "t_submit", "t_done")

    def __init__(self, job_id: str, *, op: str, rows: List[Any],
                 k: Optional[int], target_se: Optional[float],
                 ess_floor: Optional[float], seed: int,
                 model: Optional[str], client: Optional[str],
                 ckpt_dir: Optional[str], ckpt_every: int):
        self.job_id = job_id
        self.op = op
        self.rows = rows
        self.k = k
        self.target_se = target_se
        self.ess_floor = ess_floor
        self.seed = int(seed)
        self.model = model
        self.client = client
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.state = "running"
        self.results: List[Any] = [None] * len(rows)
        self.next_row = 0          # first row not yet submitted
        self.completed = 0         # rows with a result, any order
        self.prefix = 0            # longest completed prefix (checkpointable)
        self.checkpointed = 0      # prefix length of the newest checkpoint
        self.error: Optional[str] = None
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None

    def identity(self) -> Dict[str, Any]:
        return {"op": self.op, "k": self.k, "target_se": self.target_se,
                "ess_floor": self.ess_floor, "seed": self.seed,
                "model": self.model, "n_rows": len(self.rows),
                "rows_sha256": _rows_digest(self.rows)}

    def row_seed(self, i: int) -> int:
        # the job determinism contract: row i's RNG stream is a pure
        # function of (job_seed, i) — resume, pacing, and routing can
        # never change it
        return (self.seed + i) % (2 ** 31)

    def status_doc(self, include_results: bool = False) -> Dict[str, Any]:
        doc = {"job": self.job_id, "state": self.state, "op": self.op,
               "rows": len(self.rows), "submitted": self.next_row,
               "completed": self.completed, "prefix": self.prefix,
               "checkpointed": self.checkpointed, "error": self.error}
        if include_results:
            doc["results"] = list(self.results)
        return doc


class BulkJobManager:
    """The tier's background lane: admits job docs, pumps their rows
    through the replica router while the fleet has idle headroom, and
    checkpoints completed prefixes under the checkpoint manifests.

    ``router`` is the tier's :class:`~.router.ReplicaRouter`; ``admit`` /
    ``refund`` are the tier's quota hooks (``(client, cost, model)``), so
    bulk rows meter through the same per-(client, model) buckets as
    interactive traffic. ``headroom`` caps the tier-wide outstanding count
    the pump will fill up to (bulk never submits while
    ``router.outstanding >= headroom`` — that capacity belongs to latency
    traffic); ``chunk`` bounds one pump tick's submission burst, which is
    also the yield granularity to an arriving interactive burst.
    """

    #: how long the pump sleeps when there is no headroom / no work
    POLL_S = 0.01

    def __init__(self, router, *, admit: Callable[..., None],
                 refund: Callable[..., None], headroom: int,
                 chunk: int = 32, registry=None, clock=time.monotonic):
        self._router = router
        self._admit = admit
        self._refund = refund
        self.headroom = max(1, int(headroom))
        self.chunk = max(1, int(chunk))
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._jobs: "Dict[str, BulkJob]" = {}
        self._order: List[str] = []    # FIFO among running jobs
        self._next_id = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: pump pause until this clock time (quota refill back-off)
        self._pause_until = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._pump_loop,
                                        name="iwae-tier-jobs", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the pump (already-submitted rows complete during the
        router's drain; unsubmitted rows simply stay unsubmitted — that is
        the interruption the checkpoint/resume contract exists for)."""
        self._stop.set()
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()

    # -- wire ops -----------------------------------------------------------

    def submit(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Admit one ``submit_job`` doc; returns the initial status doc.
        Malformed docs raise ``ValueError`` (the server maps it to a typed
        ``bad_request`` response)."""
        op = obj.get("job_op", "score")
        if not isinstance(op, str) or not self._router.serves_op(op):
            raise ValueError(
                f"'job_op' must name an op this fleet serves, got {op!r}")
        rows = obj.get("x")
        if not isinstance(rows, (list, tuple)) or len(rows) == 0 or \
                not isinstance(rows[0], (list, tuple)):
            raise ValueError(
                "'x' must be a non-empty list of rows for a bulk job")
        rows = [list(r) for r in rows]
        k = obj.get("k")
        if k is not None:
            k = validate_k(k, 2 ** 31 - 1)
        target_se = obj.get("target_se")
        ess_floor = obj.get("ess_floor")
        if target_se is not None or ess_floor is not None:
            # the ONE shared validator, at the job boundary too (the
            # router re-validates per row with the fleet's real k_max)
            validate_adaptive_target(target_se, ess_floor,
                                     k if k is not None else 2 ** 31 - 1,
                                     2 ** 31 - 1)
        seed = obj.get("seed", 0)
        if not isinstance(seed, int) or isinstance(seed, bool) or \
                not 0 <= seed < 2 ** 31:
            raise ValueError(
                f"job 'seed' must be an integer in [0, 2**31), got {seed!r}")
        model = self._router.resolve_model(obj.get("model"))
        client = obj.get("client")
        if client is not None and not isinstance(client, str):
            raise ValueError(f"'client' must be a string, got "
                             f"{type(client).__name__}")
        ckpt_dir = obj.get("checkpoint_dir")
        if ckpt_dir is not None and not isinstance(ckpt_dir, str):
            raise ValueError("'checkpoint_dir' must be a path string")
        ckpt_every = obj.get("checkpoint_every", 256)
        if not isinstance(ckpt_every, int) or isinstance(ckpt_every, bool) \
                or ckpt_every < 1:
            raise ValueError(
                f"'checkpoint_every' must be a positive integer, "
                f"got {ckpt_every!r}")
        with self._lock:
            self._next_id += 1
            job_id = f"job-{self._next_id}"
        job = BulkJob(job_id, op=op, rows=rows, k=k, target_se=target_se,
                      ess_floor=ess_floor, seed=seed, model=model,
                      client=client, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every)
        if obj.get("resume"):
            if ckpt_dir is None:
                raise ValueError(
                    "'resume' needs a 'checkpoint_dir' to resume from")
            self._restore(job)
        with self._lock:
            self._jobs[job_id] = job
            self._order.append(job_id)
        self._count("jobs/submitted")
        self._wake.set()
        return job.status_doc()

    def status(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        job_id = obj.get("job")
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise ValueError(f"unknown job {job_id!r} (this tier knows "
                             f"{sorted(self._jobs)})")
        with self._lock:
            return job.status_doc(include_results=bool(obj.get("results")))

    def jobs_doc(self) -> List[Dict[str, Any]]:
        """Every known job's status (the stats document's jobs section)."""
        with self._lock:
            return [self._jobs[j].status_doc() for j in self._order]

    # -- the pump -----------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(n)

    def _runnable(self) -> Optional[BulkJob]:
        with self._lock:
            for job_id in self._order:
                job = self._jobs[job_id]
                if job.state == "running" and job.next_row < len(job.rows):
                    return job
        return None

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            self._checkpoint_due()
            job = self._runnable()
            if job is None:
                self._wake.wait(timeout=0.05)
                with self._lock:
                    self._wake.clear()
                continue
            with self._lock:
                pause_until = self._pause_until
            if self._clock() < pause_until:
                time.sleep(self.POLL_S)
                continue
            # the yield gate: bulk only fills capacity below `headroom`;
            # an interactive burst raises the outstanding count and the
            # pump stops submitting until it drains back down
            free = self.headroom - self._router.outstanding
            if free <= 0:
                time.sleep(self.POLL_S)
                continue
            self._submit_chunk(job, min(free, self.chunk))

    def _submit_chunk(self, job: BulkJob, n: int) -> None:
        with self._lock:
            start = job.next_row
            n = min(n, len(job.rows) - start)
            if n <= 0 or job.state != "running":
                return
        try:
            self._admit(job.client, n, model=job.model)
        except QuotaExceeded as e:
            # the job lane never fails on quota: it waits out the refill
            # (the hint is exact — quotas.py computes it) and tries again
            backoff = self._clock() + \
                max(self.POLL_S, float(getattr(e, "retry_after_s", None)
                                       or 0.05))
            with self._lock:
                self._pause_until = backoff
            return
        submitted = 0
        kw: Dict[str, Any] = {}
        if job.target_se is not None:
            kw["target_se"] = job.target_se
        if job.ess_floor is not None:
            kw["ess_floor"] = job.ess_floor
        try:
            for i in range(start, start + n):
                fut = self._router.submit(
                    job.op, job.rows[i], k=job.k, seed=job.row_seed(i),
                    model=job.model, **kw)
                with self._lock:
                    job.next_row = i + 1
                submitted += 1
                fut.add_done_callback(
                    lambda f, j=job, idx=i: self._row_done(j, idx, f))
        except Exception as e:
            # a shed/ceiling rejection mid-chunk: refund the unsubmitted
            # remainder (quota meters served work) and back off — the rows
            # stay queued in the job, not lost
            if submitted < n:
                self._refund(job.client, n - submitted, model=job.model)
            backoff = self._clock() + \
                max(self.POLL_S, float(getattr(e, "retry_after_s", None)
                                       or 0.05))
            with self._lock:
                self._pause_until = backoff

    def _row_done(self, job: BulkJob, i: int, fut) -> None:
        # the callback fires after resolution, so exception()/result() are
        # non-blocking here — fetched BEFORE the lock regardless, so the
        # critical section provably never waits on a future
        exc = fut.exception()
        r = None if exc is not None else fut.result()
        with self._lock:
            if exc is not None:
                if job.state == "running":
                    job.state = "failed"
                    job.error = f"row {i}: {type(exc).__name__}: {exc}"
                    job.t_done = self._clock()
                return
            job.results[i] = r.tolist() if hasattr(r, "tolist") else r
            job.completed += 1
            while job.prefix < len(job.rows) and \
                    job.results[job.prefix] is not None:
                job.prefix += 1
            if job.state == "running" and job.completed == len(job.rows):
                job.state = "done"
                job.t_done = self._clock()
        self._count("jobs/rows_completed")
        self._wake.set()

    # -- checkpoint / resume (the checkpoint manifests) ---------------------

    def _checkpoint_due(self) -> None:
        """Write checkpoints for jobs whose completed prefix advanced past
        the cadence (or just finished). Runs on the pump thread: file IO
        and hashing never block a router completion callback."""
        with self._lock:
            due = [j for j in self._jobs.values()
                   if j.ckpt_dir is not None and j.prefix > j.checkpointed
                   and (j.prefix - j.checkpointed >= j.ckpt_every
                        or j.state == "done")]
        for job in due:
            try:
                self._write_checkpoint(job)
            except OSError as e:
                with self._lock:
                    job.error = f"checkpoint write failed: {e}"

    def _write_checkpoint(self, job: BulkJob) -> None:
        # the manifest helpers live in utils/checkpoint.py, which imports
        # torch at module scope: deferred, so the frontend imports no torch
        # (the tier's fake-engine tests never checkpoint)
        from iwae_replication_project_tpu_torch.utils.checkpoint import (
            write_manifest)

        with self._lock:
            prefix = job.prefix
            payload = {"job": job.identity(), "done": prefix,
                       "results": job.results[:prefix]}
        step_dir = os.path.join(os.path.abspath(job.ckpt_dir), str(prefix))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, "progress.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.write("\n")
        os.replace(tmp, os.path.join(step_dir, "progress.json"))
        # seal the step with the same (size, sha256) manifest training
        # checkpoints carry; resume verifies before trusting it
        write_manifest(job.ckpt_dir, prefix)
        with self._lock:
            job.checkpointed = prefix
            stale = [s for s in self._step_list(job.ckpt_dir)
                     if s != prefix]
        # retain only the newest sealed step plus its predecessor (the
        # fallback verify_checkpoint walks to when the newest is torn)
        for s in sorted(stale, reverse=True)[1:]:
            self._drop_step(job.ckpt_dir, s)
        self._count("jobs/checkpoints")

    @staticmethod
    def _step_list(ckpt_dir: str) -> List[int]:
        root = os.path.abspath(ckpt_dir)
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root)
                      if d.isdigit() and
                      os.path.isfile(os.path.join(root, d, "progress.json")))

    @staticmethod
    def _drop_step(ckpt_dir: str, step: int) -> None:
        import shutil
        root = os.path.abspath(ckpt_dir)
        shutil.rmtree(os.path.join(root, str(step)), ignore_errors=True)
        try:
            os.remove(os.path.join(root, "manifests", f"{step}.json"))
        except OSError:
            pass

    def _restore(self, job: BulkJob) -> None:
        """Load the newest intact checkpoint into `job` (prefix results +
        resume point). Torn steps fall back to the previous sealed one; a
        checkpoint written by a different job doc is a ValueError (typed
        ``bad_request`` at the wire)."""
        from iwae_replication_project_tpu_torch.utils.checkpoint import (
            verify_checkpoint)

        for step in sorted(self._step_list(job.ckpt_dir), reverse=True):
            problem = verify_checkpoint(job.ckpt_dir, step)
            if problem is not None:
                continue   # torn/corrupt step: fall back to the previous
            path = os.path.join(os.path.abspath(job.ckpt_dir), str(step),
                                "progress.json")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if payload.get("job") != job.identity():
                raise ValueError(
                    f"checkpoint at {job.ckpt_dir!r} was written by a "
                    f"different job (op/k/targets/seed/payload differ); "
                    f"refusing to resume")
            done = int(payload.get("done", 0))
            results = payload.get("results", [])
            if done != len(results) or done > len(job.rows):
                continue   # internally inconsistent: fall back
            for i in range(done):
                job.results[i] = results[i]
            job.next_row = done
            job.completed = done
            job.prefix = done
            job.checkpointed = done
            if done == len(job.rows):
                job.state = "done"
                job.t_done = self._clock()
            self._count("jobs/resumed")
            return
        # nothing intact to resume from: a fresh start IS the contract
        # (first run of a job that will checkpoint into this directory)

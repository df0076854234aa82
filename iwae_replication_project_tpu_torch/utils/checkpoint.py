"""Checkpoint and resume (port of ``utils/checkpoint.py``: its contract,
with ``torch.save`` in place of Orbax).

A checkpoint is the full resumable state: the parameters, Adam's
``exp_avg``, ``exp_avg_sq`` and ``step`` per parameter, the training
generator's state, ``state.step``, the stage, the passes done within it (a
mid-stage save) and the experiment config JSON. Step ``s`` lives in
``<directory>/<s>/`` (``state.pt`` and ``meta.json``), written into a
temporary directory first and moved into place with ``os.replace``, so a
reader sees a whole step or none. The newest ``keep`` steps are retained.

**Integrity**: every save also writes ``<directory>/manifests/<s>.json``
(size and SHA-256 of each file of the step). :func:`restore_latest`
verifies the newest step against it first and, on a mismatch (a write
truncated by a preemption), falls back to the newest intact retained step
with a loud warning. Training replays deterministically, so resuming from an
older step reproduces bitwise the run the newer one would have.

Restore writes into a state built like the one saved (the parameters and,
on CUDA, the generator stay the same tensors and object), on the run's
device, before any CUDA graph is captured against that state.

**Under a mesh** (``parallel/``) every rank calls :func:`save_checkpoint`
and :func:`restore_latest` with its ``mesh``. The parameters and Adam
moments are replicated, but each rank's generators (its noise, shuffle and
binarization streams) are its own: rank 0 gathers them all into the
checkpoint and writes it alone (JAX :209, :244), and on restore each rank
takes its own back. A checkpoint resumes only under the mesh shape that
wrote it.

**Serving a run** needs only its architecture and weights:
:func:`stored_config_json` and :func:`restore_latest_params` read them from
the newest intact step, with :func:`restore_latest`'s fallback, and from a
run trained on any mesh.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from typing import List, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.training.train_step import TrainState
from iwae_replication_project_tpu_torch.utils.faults import (
    SITE_CKPT_SAVE,
    fault_point,
)
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointConfigMismatch(ValueError):
    """The stored config belongs to a different experiment: a run-dir
    collision, never an integrity problem, so no fallback."""


def _config_identity(config_json: str) -> Optional[dict]:
    """The science-field subset of a stored config JSON (paths and execution
    knobs may differ between save and resume); None for an unparseable
    payload (no information, not a mismatch)."""
    import dataclasses

    from iwae_replication_project_tpu_torch.utils.config import (
        SCIENCE_FIELDS,
        ExperimentConfig,
    )
    try:
        d = json.loads(config_json)
    except json.JSONDecodeError:
        return None
    if not isinstance(d, dict):
        return None
    defaults = dataclasses.asdict(ExperimentConfig())
    return {k: (list(v) if isinstance(v, (tuple, list)) else v)
            for k in SCIENCE_FIELDS
            for v in [d.get(k, defaults.get(k))]}


# ---------------------------------------------------------------------------
# layout and integrity manifests
# ---------------------------------------------------------------------------

def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(int(step)))


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), "manifests",
                        f"{int(step)}.json")


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _step_files(step_dir: str) -> List[str]:
    return sorted(os.path.relpath(os.path.join(d, f), step_dir)
                  for d, _, files in os.walk(step_dir) for f in files)


def write_manifest(directory: str, step: int) -> str:
    """Record (size, sha256) of every file of the step, atomically, outside
    the step directory; returns the manifest's path."""
    step_dir = _step_dir(directory, step)
    files = {rel: {"bytes": os.path.getsize(os.path.join(step_dir, rel)),
                   "sha256": _file_digest(os.path.join(step_dir, rel))}
             for rel in _step_files(step_dir)}
    path = _manifest_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"step": int(step), "files": files}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def prune_manifests(directory: str, live_steps: List[int]) -> None:
    """Drop the manifests of steps retention deleted."""
    mdir = os.path.join(os.path.abspath(directory), "manifests")
    if not os.path.isdir(mdir):
        return
    live = {f"{int(s)}.json" for s in live_steps}
    for fname in os.listdir(mdir):
        if fname.endswith(".json") and fname not in live:
            os.remove(os.path.join(mdir, fname))


def verify_checkpoint(directory: str, step: int) -> Optional[str]:
    """None when the step's files match its manifest (or it has none), else
    a description of the first mismatch."""
    mpath = _manifest_path(directory, step)
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return f"unreadable manifest {mpath}: {e}"
    step_dir = _step_dir(directory, step)
    if not os.path.isdir(step_dir):
        return f"step directory missing: {step_dir}"
    for rel, want in sorted(manifest.get("files", {}).items()):
        path = os.path.join(step_dir, rel)
        if not os.path.isfile(path):
            return f"missing file: {rel}"
        size = os.path.getsize(path)
        if size != want["bytes"]:
            return (f"size mismatch on {rel}: {size} bytes on disk vs "
                    f"{want['bytes']} in the manifest (truncated write?)")
        if _file_digest(path) != want["sha256"]:
            return f"checksum mismatch on {rel} (corrupted contents)"
    return None


def checkpoint_steps(directory: str) -> List[int]:
    """Retained step numbers, newest first."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(d) for d in os.listdir(directory) if d.isdigit()
                   and os.path.isdir(os.path.join(directory, d))),
                  reverse=True)


def truncate_newest_checkpoint(directory: str) -> Optional[str]:
    """Truncate the newest step's largest file to half its size (a write cut
    by a preemption); returns its path, None when there is none."""
    steps = checkpoint_steps(directory)
    if not steps:
        return None
    step_dir = _step_dir(directory, steps[0])
    files = [(os.path.getsize(os.path.join(step_dir, rel)), rel)
             for rel in _step_files(step_dir)]
    if not files:
        return None
    size, rel = max(files)
    path = os.path.join(step_dir, rel)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    return path


def _integrity_warn(directory: str, step: int, problem: str) -> None:
    msg = (f"WARNING: checkpoint step {step} under {directory!r} failed "
           f"integrity verification ({problem}); falling back to the newest "
           f"intact retained checkpoint: the deterministic pass replay "
           f"reproduces the lost work bitwise")
    print(msg)
    print(msg, file=sys.stderr)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _streams(state: TrainState) -> dict:
    """This rank's generator states: the training generator and the
    streams."""
    return {"generator": state.generator.get_state(),
            "streams": {name: g.get_state()
                        for name, g in sorted(state.streams.items())}}


def _payload(state: TrainState, mesh=None) -> dict:
    leaves = tree_leaves(state.params)
    opt = [state.optimizer.state.get(p, {}) for p in leaves]
    cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    out = {
        "params": [cpu(p) for p in leaves],
        "exp_avg": [cpu(s["exp_avg"]) if s else None for s in opt],
        "exp_avg_sq": [cpu(s["exp_avg_sq"]) if s else None for s in opt],
        "adam_step": [cpu(s["step"]) if s else None for s in opt],
        "step": int(state.step),
        **_streams(state),
    }
    if _distributed(mesh):
        import torch.distributed as dist
        ranks = [None] * mesh.size
        dist.all_gather_object(ranks, _streams(state))
        out["mesh"] = [mesh.dp, mesh.sp]
        out["ranks"] = ranks
    return out


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.device_mesh is not None


def save_checkpoint(directory: str, step: int, state: TrainState, stage: int,
                    config_json: str = "", keep: int = 3,
                    passes_done: Optional[int] = None, mesh=None) -> None:
    """Save `state` as step `step`. `passes_done` = passes completed within
    `stage` at save time; None means the stage finished (resume continues
    at the next stage). A step that already exists is replaced. Under a
    process group every rank of `mesh` calls this; rank 0 writes."""
    payload = _payload(state, mesh)
    if _distributed(mesh) and mesh.rank != 0:
        mesh.barrier()  # rank 0's write is durable past this point
        return
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    meta = {"config": config_json, "stage": int(stage), "step": int(step)}
    if passes_done is not None:
        meta["passes_done"] = int(passes_done)
    tmp = os.path.join(directory, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    dest = _step_dir(directory, step)
    if os.path.isdir(dest):
        old = dest + f".old-{os.getpid()}"
        os.replace(dest, old)
        os.replace(tmp, dest)
        shutil.rmtree(old)
    else:
        os.replace(tmp, dest)
    steps = checkpoint_steps(directory)
    for s in steps[max(1, keep):]:
        shutil.rmtree(_step_dir(directory, s))
    write_manifest(directory, step)
    prune_manifests(directory, steps[:max(1, keep)])
    # fires with the save durable: a fault here models corruption landing
    # after a successful write
    fault_point(SITE_CKPT_SAVE, directory=directory, step=int(step))
    if _distributed(mesh):
        mesh.barrier()


def _read_meta(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), META_FILE), "r",
              encoding="utf-8") as f:
        return json.load(f)


def _intact_steps(directory: str):
    """``(step, vouched)`` of the retained steps, newest first, that match
    their manifest or have none (``vouched``: a manifest vouches for the
    step); a step that fails it is passed over with a warning."""
    for step in checkpoint_steps(directory):
        problem = verify_checkpoint(directory, step)
        if problem is not None:
            _integrity_warn(directory, step, problem)
            continue
        yield step, os.path.isfile(_manifest_path(directory, step))


def latest_step(directory: str) -> Optional[int]:
    """The newest intact retained step under `directory`, or None (JAX
    :287-293): the step :func:`restore_latest` would resume from."""
    return next((step for step, _ in _intact_steps(directory)), None)


def restore_latest(directory: str, template: TrainState, *,
                   expect_config_json: Optional[str] = None, mesh=None
                   ) -> Optional[Tuple[int, TrainState, int, Optional[int]]]:
    """Restore ``(step, state, stage, passes_done)`` from the newest intact
    checkpoint into `template` (a state built like the saved one), or None.
    ``passes_done`` is None when the stage had finished.

    A config whose science fields differ from `expect_config_json` raises
    :class:`CheckpointConfigMismatch`. A step that fails its manifest, or
    has none and cannot be read, is passed over with a warning; a step its
    manifest vouches for that still cannot be read raises (a bug, not
    corruption). Under a process group each rank of `mesh` restores its
    own generators.
    """
    for step, vouched in _intact_steps(directory):
        try:
            return _restore_step(directory, step, template,
                                 expect_config_json, mesh)
        except CheckpointConfigMismatch:
            raise
        except Exception as e:
            if vouched:
                raise
            _integrity_warn(directory, step,
                            f"unreadable checkpoint without a manifest: {e}")
    return None


def stored_config_json(directory: str) -> Optional[str]:
    """The experiment-config JSON the newest intact step was written under
    (JAX :257-280), None when there is no checkpoint or it stored none. A
    step that fails its manifest, or has none and an unreadable
    ``meta.json``, is passed over with a warning, as in
    :func:`restore_latest`, so it names the step that restore reads."""
    for step, _ in _intact_steps(directory):
        try:
            meta = _read_meta(directory, step)
        except (OSError, ValueError) as e:
            _integrity_warn(directory, step, f"unreadable meta: {e}")
            continue
        return meta.get("config") or None
    return None


def restore_latest_params(directory: str, params) -> Optional[int]:
    """Copy the parameters of the newest intact step into the tree
    `params` (built like the saved one) and return the step, or None when
    no step restores. Adam's moments, the generators and the mesh the run
    trained on are not read. The fallback is :func:`restore_latest`'s."""
    leaves = tree_leaves(params)
    for step, vouched in _intact_steps(directory):
        try:
            saved = torch.load(os.path.join(_step_dir(directory, step),
                                            STATE_FILE),
                               map_location="cpu", weights_only=True)["params"]
        except Exception as e:
            if vouched:
                raise
            _integrity_warn(directory, step,
                            f"unreadable checkpoint without a manifest: {e}")
            continue
        if [tuple(t.shape) for t in saved] != \
                [tuple(p.shape) for p in leaves]:
            raise ValueError(f"checkpoint step {step} at {directory!r} holds "
                             f"parameters of other shapes than the model "
                             f"its config describes")
        with torch.no_grad():
            for p, t in zip(leaves, saved):
                p.copy_(t)
        return step
    return None


def _restore_step(directory: str, step: int, template: TrainState,
                  expect_config_json: Optional[str], mesh=None
                  ) -> Tuple[int, TrainState, int, Optional[int]]:
    meta = _read_meta(directory, step)
    stage = int(meta["stage"])
    passes_done = meta.get("passes_done")
    if passes_done is not None:
        passes_done = int(passes_done)
    if expect_config_json:
        stored_id = _config_identity(meta.get("config", ""))
        expect_id = _config_identity(expect_config_json)
        if stored_id is not None and expect_id is not None \
                and stored_id != expect_id:
            raise CheckpointConfigMismatch(
                f"checkpoint at {directory!r} was written by a different "
                f"experiment config; refusing to resume.\n"
                f"stored:  {stored_id}\ncurrent: {expect_id}")
        stored = json.loads(meta.get("config", "") or "{}")
        current = json.loads(expect_config_json)
        if isinstance(stored, dict) and \
                stored.get("compute_dtype") != current.get("compute_dtype"):
            print(f"note: checkpoint was trained with compute_dtype="
                  f"{stored.get('compute_dtype')!r}; resuming under "
                  f"compute_dtype={current.get('compute_dtype')!r} (each "
                  f"metrics row stamps its own 'bfloat16' flag)")
    payload = torch.load(os.path.join(_step_dir(directory, step), STATE_FILE),
                         map_location="cpu", weights_only=True)
    leaves = tree_leaves(template.params)
    if len(payload["params"]) != len(leaves):
        raise ValueError(f"checkpoint step {step} holds "
                         f"{len(payload['params'])} parameters, the state "
                         f"{len(leaves)}")
    opt = template.optimizer
    capturable = any(g.get("capturable") for g in opt.param_groups)
    with torch.no_grad():
        for i, p in enumerate(leaves):
            p.copy_(payload["params"][i])
            if payload["exp_avg"][i] is None:
                opt.state.pop(p, None)
                continue
            step_t = payload["adam_step"][i].to(
                p.device if capturable else "cpu", torch.float32)
            opt.state[p] = {
                "step": step_t,
                "exp_avg": payload["exp_avg"][i].to(p.device),
                "exp_avg_sq": payload["exp_avg_sq"][i].to(p.device)}
    saved_mesh = payload.get("mesh")
    here = [mesh.dp, mesh.sp] if _distributed(mesh) else None
    if saved_mesh != here:
        raise CheckpointConfigMismatch(
            f"checkpoint step {step} at {directory!r} was written under "
            f"mesh {saved_mesh or 'none'} (dp, sp), this run has "
            f"{here or 'none'}: each rank's generators resume only under "
            f"the mesh that wrote them")
    own = payload["ranks"][mesh.rank] if here else payload
    template.generator.set_state(own["generator"])
    streams = own.get("streams", {})
    if sorted(streams) != sorted(template.streams):
        raise ValueError(f"checkpoint step {step} holds generator streams "
                         f"{sorted(streams)}, the state "
                         f"{sorted(template.streams)}")
    for name, st in streams.items():
        template.streams[name].set_state(st)
    template.step = int(payload["step"])
    template.graphs.clear()  # captured against the tensors just replaced
    return step, template, stage, passes_done

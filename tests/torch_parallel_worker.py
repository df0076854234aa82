"""The ranks of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_api.py): gloo worlds on the CPU, spawned with
``parallel.multihost.spawn``.

This module imports only torch, numpy and the port, never JAX: the parent
test computes the JAX side, rebuilds each mesh coordinate's draws from
JAX's folded keys and hands them to the ranks as numpy arrays. Each rank
joins its world through a ``file://`` rendezvous under the test's
temporary directory, runs one job and saves its result as
``rank<r>.pt`` there; :func:`launch` returns those results, rank by rank.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os

import numpy as np
import torch

from iwae_replication_project_tpu_torch.convert import params_from_numpy
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.parallel import dp as pdp
from iwae_replication_project_tpu_torch.parallel import eval as peval
from iwae_replication_project_tpu_torch.parallel import (
    make_mesh,
    multihost,
)
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves, tree_map

#: a spawned world must finish within this many seconds, else it is killed
WORLD_TIMEOUT = 240.0


def launch(job: str, world: int, payload: dict, tmp_dir,
           codes=None) -> list:
    """Run `job` on `world` gloo ranks on the CPU; returns each rank's
    result (None for a rank that saved none). Fails when the ranks' exit
    codes are not `codes` (default: all 0) or the world outlives its
    timeout."""
    out = os.path.join(str(tmp_dir), f"{job}-{world}-{os.getpid()}")
    os.makedirs(out, exist_ok=True)
    init = f"file://{out}/rendezvous"
    got = multihost.spawn(_entry, world, (job, payload, out, init),
                          timeout=WORLD_TIMEOUT, grace=10.0)
    want = [0] * world if codes is None else list(codes)
    assert got == want, f"{job}: rank exit codes {got}, expected {want}"
    paths = [os.path.join(out, f"rank{r}.pt") for r in range(world)]
    return [torch.load(p, weights_only=False) if os.path.exists(p) else None
            for p in paths]


def _entry(rank, world, job, payload, out, init):
    torch.set_num_threads(1)
    kw = {}
    if "timeout_s" in payload:
        kw["timeout"] = datetime.timedelta(seconds=payload["timeout_s"])
    if payload.get("backend") == "nccl":  # one card per rank
        multihost.initialize(init, world, rank,
                             device=torch.device("cuda", rank), **kw)
    elif payload.get("device") == "cuda":  # several ranks on the one card
        multihost.initialize(init, world, rank, backend="gloo",
                             device=torch.device("cuda", 0), **kw)
    else:
        multihost.initialize(init, world, rank, device="cpu", **kw)
    try:
        result = JOBS[job](payload)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def _cfg(payload) -> tmodel.ModelConfig:
    return tmodel.ModelConfig(**payload["cfg"])


def _params(payload):
    return params_from_numpy(payload["params"], "cpu")


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _leaves(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


def _spec(case) -> ObjectiveSpec:
    return ObjectiveSpec(**{k: case[k] for k in
                            ("name", "k", "k2", "p", "alpha", "beta")})


# --------------------------------------------------------------------------
# jobs
# --------------------------------------------------------------------------

def _job_value_and_grad(payload):
    """Every case's ``(bound, gradient leaves)`` on this rank's injected
    draws; the errors of meshes the world cannot hold; the sp merge of the
    augmented online carry."""
    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    x = torch.from_numpy(payload["x"])
    b = x.shape[0] // mesh.dp
    x_local = x[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
    out = {"cases": []}
    for case in payload["cases"]:
        cfg, params = _cfg(case), _params(case)
        vg = pdp.make_parallel_value_and_grad(_spec(case), cfg, mesh,
                                              x.shape[0])
        eps = _t(case["eps"][(mesh.dp_rank, mesh.sp_rank)])
        bound, grads = vg(params, x_local, eps=eps)
        out["cases"].append((float(bound), _leaves(grads)))
    errors = []
    for dp, sp in payload.get("bad_meshes", ()):
        try:
            make_mesh(dp, sp, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    if payload.get("host_local"):
        # each rank holds its own B/dp rows; uneven holdings raise on all
        fed = multihost.host_local_batch_to_global(x_local, mesh)
        uneven = x_local[:b - mesh.rank % 2]
        try:
            multihost.host_local_batch_to_global(uneven, mesh)
            out["uneven"] = None
        except ValueError as e:
            out["uneven"] = str(e)
        out["fed"] = torch.equal(fed, x_local)
    if "lse" in payload:
        lw = torch.from_numpy(payload["lse"][mesh.sp_rank])
        from iwae_replication_project_tpu_torch.ops import logsumexp as lse
        st = lse.online_lse_var_update(
            lse.online_lse_var_init(lw.shape[1:]), lw)
        merged = peval.merge_lse_var_over_sp(mesh, st)
        out["lse"] = (merged.m, merged.s, merged.s2, merged.n)
        out["dlme"] = pdp.distributed_logmeanexp(lw, mesh, 12, scale=2.0)
    return out


def _fresh_state(payload, mesh, seed=0):
    """A rank's state of the mesh holding the payload's parameters."""
    cfg = _cfg(payload)
    state = ts.create_train_state(seed, cfg, lr=payload["lr"], device="cpu")
    with torch.no_grad():
        for p, q in zip(tree_leaves(state.params),
                        tree_leaves(_params(payload))):
            p.copy_(q)
    return pdp.parallel_train_state(mesh, state)


def _job_epoch(payload):
    """One pass on injected draws (against JAX's); two passes from the same
    seed on the rank's own streams (equal bits), recording each step's
    batch rows."""
    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    cfg = _cfg(payload)
    spec = _spec(payload["case"])
    x = torch.from_numpy(payload["x"])
    n_train, batch = x.shape[0], payload["batch"]
    binarize = payload["binarize"]
    out = {}

    fn = pdp.make_parallel_epoch_fn(spec, cfg, mesh, n_train, batch,
                                    stochastic_binarization=binarize)
    state = _fresh_state(payload, mesh)
    draws = payload["draws"][(mesh.dp_rank, mesh.sp_rank)]
    state, losses = fn(state, x, perm=torch.from_numpy(draws["perm"]),
                       noise=[_t(e) for e in draws["noise"]],
                       uniforms=(_t(draws["uniforms"]) if binarize
                                 else None))
    out["injected"] = (losses.clone(), _leaves(state.params))

    seen = []
    real_vg = pdp.make_parallel_value_and_grad

    def recording(*a, **kw):
        vg = real_vg(*a, **kw)

        def wrapped(params, x_local, **kw2):
            seen.append(x_local.clone())
            return vg(params, x_local, **kw2)
        return wrapped

    runs = []
    for _ in range(2):
        pdp.make_parallel_value_and_grad = recording
        try:
            fn = pdp.make_parallel_epoch_fn(
                spec, cfg, mesh, n_train, batch,
                stochastic_binarization=binarize)
        finally:
            pdp.make_parallel_value_and_grad = real_vg
        state = _fresh_state(payload, mesh, seed=payload["seed"])
        state, losses = fn(state, x)
        runs.append((losses.clone(), _leaves(state.params),
                     [state.optimizer.state[p]["exp_avg"].clone()
                      for p in tree_leaves(state.params)],
                     state.generator.get_state(),
                     {k: g.get_state() for k, g in state.streams.items()}))
    out["runs"] = runs
    out["batches"] = seen[:n_train // batch]

    return out


def _job_facade(payload):
    """The facade's ``fit`` under the mesh against the parallel epoch
    function driven directly from the same seed; a ``train_step``."""
    from iwae_replication_project_tpu_torch.api import FlexibleModel
    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    x = torch.from_numpy(payload["x"])
    n_train, batch, f = x.shape[0], payload["batch"], payload
    mdl = FlexibleModel(*f["arch"], dataset_bias=None, loss_function="IWAE",
                        k=f["k"], seed=f["seed"], mesh=mesh,
                        device="cpu").compile()
    hist = mdl.fit(x, epochs=2, batch_size=batch, binarization="stochastic")
    direct = ts.create_train_state(f["seed"], mdl.cfg, device="cpu")
    direct = pdp.parallel_train_state(mesh, direct)
    efn = pdp.make_parallel_epoch_fn(
        ObjectiveSpec(name="IWAE", k=f["k"]), mdl.cfg, mesh, n_train, batch,
        stochastic_binarization=True)
    dlosses = []
    for _ in range(2):
        direct, losses = efn(direct, x)
        dlosses.append(float(losses.mean()))
    fit = (hist["loss"], dlosses, _leaves(mdl.params), _leaves(direct.params))
    return {"fit": fit, "step": mdl.train_step(x[:batch]),
            "epoch": mdl.epoch}


def _job_statistics(payload):
    """``parallel_training_statistics`` on this rank's injected draws."""
    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    nz = payload["noise"][(mesh.dp_rank, mesh.sp_rank)]
    noise = {
        "batches": lambda i: {
            "metrics": _t(nz["batches"][i]["metrics"]),
            "nll": lambda j, i=i: _t(nz["batches"][i]["nll"][j]),
            "recon_enc": _t(nz["batches"][i]["recon_enc"]),
            "recon_dec": _t(nz["batches"][i]["recon_dec"])},
        "activity": lambda j: _t(nz["activity"][j]),
        "pruned": lambda j: _t(nz["pruned"][j]),
    }
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, res2 = peval.parallel_training_statistics(
            _params(payload), _cfg(payload), mesh,
            torch.from_numpy(payload["x"]), payload["k"],
            batch_size=payload["batch_size"], nll_k=payload["nll_k"],
            nll_chunk=payload["nll_chunk"],
            activity_samples=payload["activity_samples"], noise=noise)
    return {"res": res, "counts": (res2["number_of_active_units"],
                                   res2["number_of_PCA_active_units"]),
            "variances": [v.clone() for v in res2["variances"]],
            "stdout": buf.getvalue()}


def _state_bits(state):
    out = _leaves(state.params)
    for p in tree_leaves(state.params):
        out += [state.optimizer.state[p][k].clone()
                for k in ("exp_avg", "exp_avg_sq", "step")]
    out.append(state.generator.get_state())
    out += [state.streams[k].get_state() for k in sorted(state.streams)]
    return out


def _job_driver(payload):
    """The staged driver on the mesh: an uninterrupted run; a run that a
    SIGTERM on rank `kill_rank` alone stops at a dispatch boundary (every
    rank saves and stops at the same pass); its resume."""
    from iwae_replication_project_tpu_torch import experiment as exp
    from iwae_replication_project_tpu_torch.utils import faults
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig)

    rank = multihost.process_info()["process_index"]
    cfg_a = ExperimentConfig(**payload["a"])
    cfg_b = ExperimentConfig(**payload["b"])
    state_a, hist_a = exp.run_experiment(cfg_a, max_batches_per_pass=2,
                                         device="cpu")
    kill = payload["kill"]
    sched = faults.FaultSchedule([faults.FaultRule(
        faults.SITE_TRAIN_PASS, faults.sigterm(),
        match=lambda c: (c["stage"], c["done"]) == kill)]) \
        if rank == payload["kill_rank"] else faults.FaultSchedule([])
    preempted = None
    with faults.installed(sched):
        try:
            exp.run_experiment(cfg_b, max_batches_per_pass=2, device="cpu")
        except exp.TrainingPreempted as e:
            preempted = (e.stage, e.passes_done)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state_b, hist_b = exp.run_experiment(cfg_b, max_batches_per_pass=2,
                                             device="cpu")
    return {"a": _state_bits(state_a), "b": _state_bits(state_b),
            "nll": (hist_a[-1]["NLL"], hist_b[-1]["NLL"]),
            "stages_b": [h["stage"] for h in hist_b],
            "preempted": preempted, "stdout": buf.getvalue()}


def _job_ddp(payload):
    """Per case, a few steps of the DDP step and of the explicit step from
    the same state on the same injected draws."""
    from iwae_replication_project_tpu_torch.parallel.auto import (
        make_ddp_train_step)
    mesh = make_mesh(payload["dp"], 1, device="cpu")
    cfg = _cfg(payload)
    xs = [torch.from_numpy(x) for x in payload["xs"]]
    eps = [_t(e[mesh.dp_rank]) for e in payload["eps"]]
    out = []
    for case in payload["cases"]:
        spec = _spec(case)
        explicit = _fresh_state(payload, mesh)
        step = pdp.make_parallel_train_step(spec, cfg, mesh)
        ddp_step, place_state, place_batch = make_ddp_train_step(spec, cfg,
                                                                 mesh)
        auto = place_state(_fresh_state(payload, mesh))
        losses = []
        for x, e in zip(xs, eps):
            explicit, m1 = step(explicit, pdp.shard_batch(mesh, x), eps=e)
            auto, m2 = ddp_step(auto, place_batch(x), eps=e)
            losses.append((float(m1["loss"]), float(m2["loss"])))
        out.append({"losses": losses, "explicit": _leaves(explicit.params),
                    "ddp": _leaves(auto.params)})
    return out


def _job_cuda_step_and_nll(payload):
    """On the card under gloo: IWAE's and DReG's step on this rank's shard
    of injected draws and the sharded NLL; rank 0 adds the single-process
    step and NLL on the whole draws (not counted in the launches)."""
    from iwae_replication_project_tpu_torch.evaluation import metrics as ev
    from iwae_replication_project_tpu_torch.objectives import (
        objective_value_and_grad)
    from iwae_replication_project_tpu_torch.ops import hot_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(payload["dp"], payload["sp"], device=dev)
    cfg = _cfg(payload)
    params = params_from_numpy(payload["params"], dev)
    x = torch.from_numpy(payload["x"]).to(dev)
    eps_full = [torch.from_numpy(e).to(dev) for e in payload["eps"]]
    k, B = eps_full[0].shape[:2]
    b, kl = B // mesh.dp, k // mesh.sp
    rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    ks = slice(mesh.sp_rank * kl, (mesh.sp_rank + 1) * kl)
    probe = mesh.all_reduce(torch.tensor([float(mesh.rank)], device=dev),
                            "max")
    out = {"max": float(probe)}
    hot_loop.reset_launch_counts()
    got = {}
    for name in payload["names"]:
        vg = pdp.make_parallel_value_and_grad(
            ObjectiveSpec(name=name, k=k), cfg, mesh, B)
        bound, grads = vg(params, x[rows],
                          eps=[e[ks, rows].contiguous() for e in eps_full])
        got[name] = (float(bound), [g.cpu() for g in tree_leaves(grads)])
    nll_x = torch.from_numpy(payload["nll_x"]).to(dev)
    nk, chunk = payload["nll_k"], payload["nll_chunk"]
    n = nll_x.shape[0]

    def noise(c):
        gc = torch.Generator(device=dev).manual_seed(100 + c)
        return [torch.randn((chunk, n, d), generator=gc, device=dev)
                for d in cfg.n_latent_enc]

    nb, per_rank = n // mesh.dp, nk // mesh.sp // chunk
    nrows = slice(mesh.dp_rank * nb, (mesh.dp_rank + 1) * nb)
    log_px = peval.parallel_streaming_log_px(
        params, cfg, mesh, nll_x[nrows], nk, chunk,
        noise=lambda j: [t[:, nrows].contiguous() for t in
                         noise(mesh.sp_rank * per_rank + j)])
    total = mesh.all_reduce(log_px.sum().reshape(1), axis="dp")
    out.update(got=got, nll=-float(total) / n,
               launches=hot_loop.launch_counts())
    if mesh.rank == 0:
        out["ref"] = {}
        for name in payload["names"]:
            bound, grads = objective_value_and_grad(
                ObjectiveSpec(name=name, k=k), params, cfg, x, eps=eps_full)
            out["ref"][name] = (float(bound),
                                [g.cpu() for g in tree_leaves(grads)])
        out["ref_nll"] = -float(ev.streaming_log_px(
            params, cfg, nll_x, nk, chunk, noise=noise).mean())
    return out


def _job_cuda_graph_vs_eager(payload):
    """On one card per rank under NCCL: passes of the parallel epoch
    replayed from its CUDA graph (the all_reduce captured in it) against
    the same passes run eagerly, from one seed; each rank's state bits and
    the launches of each path."""
    from iwae_replication_project_tpu_torch.ops import hot_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(payload["dp"], payload["sp"], device=dev)
    cfg = _cfg(payload)
    spec = _spec(payload["case"])
    x = torch.from_numpy(payload["x"]).to(dev)
    out = {"backend": mesh.backend, "same": True, "launches": []}
    fns, states = [], []
    for graph in (False, True):
        fns.append(pdp.make_parallel_epoch_fn(
            spec, cfg, mesh, x.shape[0], payload["batch"],
            stochastic_binarization=True, cuda_graph=graph))
        states.append(pdp.parallel_train_state(
            mesh, ts.create_train_state(0, cfg, device=dev)))
    for _ in range(payload["passes"]):
        losses = []
        for i, fn in enumerate(fns):
            hot_loop.reset_launch_counts()
            states[i], got = fn(states[i], x)
            torch.cuda.synchronize()
            out["launches"].append(hot_loop.launch_counts())
            losses.append(got)
        a, b = (_state_bits(st) for st in states)
        out["same"] &= torch.equal(*losses) and all(
            torch.equal(u.cpu(), v.cpu()) for u, v in zip(a, b))
    out["graphs"] = sum(len(e.steps) for e in states[1].graphs.values())
    out["params"] = [t.cpu() for t in _leaves(states[1].params)]
    return out


def table_noise_fn(table):
    """The sharded serving programs' ``noise_fn(g, seeds)`` over a table
    ``{(seed, g): [[k_chunk, d] per layer]}`` of replayed draws."""
    def noise_fn(g, seeds):
        rows = [table[(int(s), int(g))] for s in seeds]
        return [torch.from_numpy(np.stack([r[i] for r in rows], axis=1))
                for i in range(len(rows[0]))]
    return noise_fn


def _job_sharded_serving(payload):
    """The sharded serving programs on this world's mesh: the offline
    scorers on replayed draws per (dtype, k); rank 0's engine (the
    followers in ``serve_rank``) against the offline scorers on the device
    draws, bitwise, for ``score`` (serial and pipelined) and
    ``score_adaptive``; the merges of all ``-inf`` rows."""
    from iwae_replication_project_tpu_torch.parallel.eval import (
        sharded_score_adaptive_offline, sharded_score_offline)
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine, serve_rank)
    from iwae_replication_project_tpu_torch.ops import logsumexp as lse

    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    x = torch.from_numpy(payload["x"])
    seeds, kc = payload["seeds"], payload["k_chunk"]
    noise_fn = table_noise_fn(payload["table"])
    out = {"score": {}, "adaptive": {}}
    for case in payload["cases"]:
        cfg, params = _cfg(case), _params(case)
        for k in case["ks"]:
            out["score"][(case["name"], k)] = sharded_score_offline(
                params, cfg, mesh, 0, seeds, x, k, kc, noise_fn=noise_fn)
        for k, tse in case.get("adaptive", {}).items():
            out["adaptive"][(case["name"], k)] = \
                sharded_score_adaptive_offline(
                    params, cfg, mesh, 0, seeds, x, k_cap=k, target_se=tse,
                    k_chunk=kc, noise_fn=noise_fn)

    eng_case = payload["engine"]
    cfg, params = _cfg(eng_case), _params(eng_case)
    # whole buckets of >= 2 rows a rank: a 1-row encoder matmul takes
    # another BLAS path on the CPU (gemv), so its bits differ
    x, seeds = torch.from_numpy(eng_case["x"]), eng_case["seeds"]
    served = {}
    for inflight in (0, 2):
        eng = ShardedScoreEngine(params=params, model_config=cfg, mesh=mesh,
                                 k_chunk=kc, k_max=64, k=8, max_batch=4,
                                 max_inflight=inflight, timeout_s=120.0,
                                 seed=3)
        if mesh.rank == 0:
            # queued before the pump starts: every dispatch a whole bucket
            fs = [eng.submit("score", r, k=k, seed=s)
                  for k in eng_case["ks"] for s, r in zip(seeds, x)]
            fa = [eng.submit("score_adaptive", r, k=eng_case["k_cap"],
                             seed=s, target_se=eng_case["target_se"])
                  for s, r in zip(seeds, x)]
            eng.start()
            got = [f.result(timeout=120) for f in fs]
            got_a = [f.result(timeout=120) for f in fa]
            eng.stop()
            served[inflight] = (np.stack(got), np.stack(got_a),
                                eng.metrics.snapshot()["kernel"])
        else:
            served[inflight] = serve_rank(eng)
    offline = torch.stack([sharded_score_offline(
        params, eng.cfg, mesh, 3, seeds, x, k, kc) for k in eng_case["ks"]])
    offline_a = sharded_score_adaptive_offline(
        params, eng.cfg, mesh, 3, seeds, x, k_cap=eng_case["k_cap"],
        target_se=eng_case["target_se"], k_chunk=kc)
    out["engine"] = (served, offline.reshape(-1).numpy(), offline_a.numpy())

    # all -inf rows on this rank, real ones elsewhere: the merges stay
    # finite where any rank saw a sample, and never NaN
    m = torch.full((3,), -float("inf")) if mesh.sp_rank == 0 \
        else torch.tensor([0.5, -float("inf"), 2.0])
    st = lse.OnlineLSEVar(m=m, s=(m > -float("inf")).float(),
                          s2=(m > -float("inf")).float(), n=1)
    merged = peval.merge_lse_var_over_sp(mesh, st)
    plain = peval.merge_lse_over_sp(mesh, lse.OnlineLSE(m=st.m, s=st.s,
                                                        n=1))
    out["merge"] = (merged.m, merged.s, merged.s2, plain.m, plain.s)
    return out


def _job_sharded_kill(payload):
    """Rank 0 serves a sharded engine over a world of two; rank 1 dies
    after receiving a dispatch. Rank 0's futures must error, not hang."""
    import time

    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine, serve_rank)

    mesh = make_mesh(payload["dp"], payload["sp"], device="cpu")
    eng = ShardedScoreEngine(params=_params(payload), model_config=_cfg(
        payload), mesh=mesh, k_chunk=4, k_max=64, k=8, max_batch=2,
        timeout_s=None)
    if mesh.rank != 0:
        def die(*a, **kw):
            os._exit(3)
        eng._program_for = die
        return serve_rank(eng)
    eng.start()
    t0 = time.monotonic()
    fut = eng.submit("score", payload["x"][0], k=40, seed=1)
    err = fut.exception(timeout=payload["timeout_s"] * 3)
    waited = time.monotonic() - t0
    try:
        eng.stop()
        stop_err = None
    except Exception as e:  # the group is broken: reported, not hung
        stop_err = type(e).__name__
    return {"error": None if err is None else f"{type(err).__name__}: {err}",
            "waited": waited, "stop_error": stop_err}


JOBS = {"value_and_grad": _job_value_and_grad, "epoch": _job_epoch,
        "statistics": _job_statistics, "driver": _job_driver,
        "ddp": _job_ddp, "facade": _job_facade,
        "cuda_step_and_nll": _job_cuda_step_and_nll,
        "cuda_graph_vs_eager": _job_cuda_graph_vs_eager,
        "sharded_serving": _job_sharded_serving,
        "sharded_kill": _job_sharded_kill}


def numpy_tree(tree):
    """A tree of tensors as numpy arrays (for payloads)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)

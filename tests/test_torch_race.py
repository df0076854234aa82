"""The port's race detector (``analysis/race/``) against the JAX package's:
vector clocks, each happens-before edge of the detector, the cooperative
fixture pairs (a racy variant caught with a reproducing seed, its
synchronized twin clean), the schedulers, the instrumented-sync layer's
install/uninstall contract, an instrumented engine bitwise the plain one,
the static thread-escape analysis, the escape-aware lint rule, the leak
pass, the CLI, and a fuzzed sweep of the port's serving tier on the CPU
with the four contracts of ``chip_smoke.py``'s race phase.

Parity with JAX: the same cooperative fixture under the same seed gives
byte-identical report JSON from both detectors, and the leak pass gives
the same findings on the same sources. Every test that installs
instrumentation uninstalls it in a ``finally`` (files run under xdist
``--dist loadfile``, so one worker runs this whole file).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import iwae_replication_project_tpu.analysis as janalysis
import iwae_replication_project_tpu.analysis.race as jrace
import iwae_replication_project_tpu_torch.analysis.race as trace
from iwae_replication_project_tpu_torch.analysis import (
    LintConfig,
    lint_paths,
    load_config,
)
from iwae_replication_project_tpu_torch.analysis.race import (
    CooperativeScheduler,
    Instrumentation,
    PerturbFuzzer,
    RaceDetector,
    SchedulerDeadlock,
    VectorClock,
)
from iwae_replication_project_tpu_torch.analysis.race import cli as race_cli
from iwae_replication_project_tpu_torch.analysis.race import escape
from iwae_replication_project_tpu_torch.analysis.race import tier_sweep
from iwae_replication_project_tpu_torch.analysis.race.escape import (
    classify_class,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = "iwae_replication_project_tpu_torch"

#: the cooperative fixtures schedule each racy variant under these seeds;
#: the pairs' conflicting accesses are adjacent in program order, so a
#: handful of seeded interleavings reliably includes an exposing one
SEEDS = (0, 1, 2, 3, 4)

#: the race packages a fixture can run under: the port's and the JAX one
PKGS = {"port": trace, "jax": jrace}


# ---------------------------------------------------------------------------
# vector clocks
# ---------------------------------------------------------------------------

class TestVectorClock:
    def test_tick_and_dominates(self):
        vc = VectorClock()
        assert vc.time_of(0) == 0
        vc.tick(0)
        vc.tick(0)
        assert vc.time_of(0) == 2
        assert vc.dominates(0, 2)
        assert not vc.dominates(0, 3)
        assert vc.dominates(1, 0)       # time 0 is vacuously seen

    def test_join_is_componentwise_max(self):
        a, b = VectorClock({0: 3, 1: 1}), VectorClock({1: 5, 2: 2})
        a.join(b)
        assert a.c == {0: 3, 1: 5, 2: 2}
        assert b.c == {1: 5, 2: 2}      # join mutates only the receiver

    def test_copy_is_independent(self):
        a = VectorClock({0: 1})
        b = a.copy()
        b.tick(0)
        assert a.time_of(0) == 1 and b.time_of(0) == 2


# ---------------------------------------------------------------------------
# detector core: each HB edge, exercised directly (two OS threads whose REAL
# ordering is enforced by raw untraced events, so the only HB the detector
# can see is what the fixture records)
# ---------------------------------------------------------------------------

def _sequenced_pair(det, first, second):
    """Run `first` then `second` on two distinct live OS threads. Raw
    events order the bodies without telling the detector anything; both
    threads stay alive until both ran (no ident reuse aliasing tids)."""
    e1, e2 = threading.Event(), threading.Event()
    errs = []

    def a():
        try:
            det.register_thread("A")
            first()
        except Exception as e:          # pragma: no cover - harness bug
            errs.append(e)
        finally:
            e1.set()
        e2.wait(10)

    def b():
        e1.wait(10)
        try:
            det.register_thread("B")
            second()
        except Exception as e:          # pragma: no cover - harness bug
            errs.append(e)
        finally:
            e2.set()

    ta = threading.Thread(target=a)
    tb = threading.Thread(target=b)
    ta.start()
    tb.start()
    ta.join(10)
    tb.join(10)
    assert not errs, errs
    assert not ta.is_alive() and not tb.is_alive()


def _lock_section(det, name, access=None):
    det.lock_acquired(name)
    if access is not None:
        access()
    det.lock_released(name)


#: (name, first body, second body, races expected): each HB mechanism and
#: its counter-examples, as (det -> callable) factories
EDGES = {
    "unordered_writes": (lambda d: d.access("v", write=True),
                         lambda d: d.access("v", write=True), 1),
    "write_then_read": (lambda d: d.access("v", write=True),
                        lambda d: d.access("v", write=False), 1),
    "read_then_read": (lambda d: d.access("v", write=False),
                       lambda d: d.access("v", write=False), 0),
    "common_lockset": (
        lambda d: _lock_section(d, "L", lambda: d.access("v", write=True)),
        lambda d: _lock_section(d, "L", lambda: d.access("v", write=True)),
        0),
    "distinct_locks": (
        lambda d: _lock_section(d, "L1", lambda: d.access("v", write=True)),
        lambda d: _lock_section(d, "L2", lambda: d.access("v", write=True)),
        1),
    "future_completion": (
        lambda d: (d.access("v", write=True), d.future_completed(7)),
        lambda d: (d.future_observed(7), d.access("v", write=True)), 0),
    "callback_registration": (
        lambda d: (d.access("v", write=True), d.future_registered(7)),
        lambda d: (d.future_observed(7), d.access("v", write=True)), 0),
    "queue_fifo": (
        lambda d: (d.access("v", write=True), d.queue_put(1)),
        lambda d: (d.queue_got(1), d.access("v", write=True)), 0),
    "event_set": (
        lambda d: (d.access("v", write=True), d.event_set(3)),
        lambda d: (d.event_observed(3), d.access("v", write=True)), 0),
    # TSan hb-mode: a section on L publishes what its thread did BEFORE it
    # to the next acquirer of L (the ownership-handoff idiom) ...
    "lock_release_acquire": (
        lambda d: (d.access("v", write=True), _lock_section(d, "L")),
        lambda d: (_lock_section(d, "L"), d.access("v", write=True)), 0),
    # ... and not to an access made before the second thread's acquire
    "lock_edge_is_directional": (
        lambda d: (d.access("v", write=True), _lock_section(d, "L")),
        lambda d: (d.access("v", write=True), _lock_section(d, "L")), 1),
    # many dynamic conflicts, one (var, stacks) program-point pair
    "deduped_per_program_point": (
        lambda d: [d.access("v", write=True) for _ in range(5)],
        lambda d: [d.access("v", write=True) for _ in range(5)], 1),
}


class TestDetectorEdges:
    @pytest.mark.parametrize("edge", sorted(EDGES))
    def test_edge(self, edge):
        first, second, races = EDGES[edge]
        det = RaceDetector(capture_stacks=False)
        _sequenced_pair(det, lambda: first(det), lambda: second(det))
        assert det.report()["total"] == races

    @pytest.mark.parametrize("edge", sorted(EDGES))
    def test_edge_verdict_is_jaxs(self, edge):
        first, second, _ = EDGES[edge]
        reports = []
        for pkg in PKGS.values():
            det = pkg.RaceDetector(capture_stacks=False)
            _sequenced_pair(det, lambda: first(det), lambda: second(det))
            reports.append(json.dumps(det.report(), sort_keys=True))
        assert reports[0] == reports[1]


# ---------------------------------------------------------------------------
# cooperative fixtures: a racy/synchronized pair per mechanism, driven by the
# seeded single-baton scheduler (every catch carries its repro seed); each
# runs under either package (`R`)
# ---------------------------------------------------------------------------

def _cooperative(seed, R=trace):
    det = R.RaceDetector()
    sched = R.CooperativeScheduler(seed)
    ins = R.Instrumentation(detector=det, fuzz=sched)

    class Box:
        def __init__(self):
            self.v = 0

    box = ins.track(Box())
    return det, sched, ins, box


def _run_threads(sched, ins, *bodies):
    def driver():
        ts = [ins.thread(target=b, name=f"w{i}")
              for i, b in enumerate(bodies)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    sched.run(driver)


def _future_fixture(seed, ordered, R=trace):
    det, sched, ins, box = _cooperative(seed, R)
    try:
        fut = ins.future()

        def producer():
            box.v = 1
            fut.set_result(1)

        def consumer():
            if ordered:
                fut.result()
            n = box.v                   # noqa: F841 - the traced read

        _run_threads(sched, ins, producer, consumer)
    finally:
        ins.uninstall()
    return det.report()


def _queue_fixture(seed, ordered, R=trace):
    det, sched, ins, box = _cooperative(seed, R)
    try:
        q = ins.make_queue()

        def producer():
            box.v = 1
            q.put("item")

        def consumer():
            if ordered:
                q.get()
            n = box.v                   # noqa: F841

        _run_threads(sched, ins, producer, consumer)
    finally:
        ins.uninstall()
    return det.report()


def _event_fixture(seed, ordered, R=trace):
    det, sched, ins, box = _cooperative(seed, R)
    try:
        evt = ins.event()

        def setter():
            box.v = 1
            evt.set()

        def waiter():
            if ordered:
                evt.wait()
            n = box.v                   # noqa: F841

        _run_threads(sched, ins, setter, waiter)
    finally:
        ins.uninstall()
    return det.report()


def _join_fixture(seed, ordered, R=trace):
    det, sched, ins, box = _cooperative(seed, R)
    try:
        def bump():
            box.v = box.v + 1

        def driver():
            t1 = ins.thread(target=bump, name="w1")
            t2 = ins.thread(target=bump, name="w2")
            if ordered:
                t1.start()
                t1.join()               # join edge orders the pair
                t2.start()
                t2.join()
            else:
                t1.start()
                t2.start()
                t1.join()
                t2.join()

        sched.run(driver)
    finally:
        ins.uninstall()
    return det.report()


def _callback_fixture(seed, ordered, R=trace):
    det, sched, ins, box = _cooperative(seed, R)
    try:
        fut = ins.future()
        if ordered:
            # registrant writes, then registers a callback reading the same
            # state; a second thread completes the future: the registration
            # edge orders write -> callback whatever the completer
            def driver():
                box.v = 1
                fut.add_done_callback(lambda f: box.v)
                t = ins.thread(target=lambda: fut.set_result(1),
                               name="comp")
                t.start()
                t.join()
        else:
            # two futures completed by two threads, both callbacks write
            # the same attribute on unordered completer threads
            fut2 = ins.future()

            def bump(f):
                box.v = box.v + 1

            fut.add_done_callback(bump)
            fut2.add_done_callback(bump)

            def driver():
                t1 = ins.thread(target=lambda: fut.set_result(1), name="c1")
                t2 = ins.thread(target=lambda: fut2.set_result(1),
                                name="c2")
                t1.start()
                t2.start()
                t1.join()
                t2.join()

        sched.run(driver)
    finally:
        ins.uninstall()
    return det.report()


_PAIRS = {
    "future": _future_fixture,
    "queue": _queue_fixture,
    "event": _event_fixture,
    "start_join": _join_fixture,
    "callback": _callback_fixture,
}


class TestCooperativePairs:
    @pytest.mark.parametrize("mechanism", sorted(_PAIRS))
    def test_racy_variant_is_caught_with_a_repro_seed(self, mechanism):
        fixture = _PAIRS[mechanism]
        caught = [s for s in SEEDS if fixture(s, ordered=False)["total"] > 0]
        assert caught, f"{mechanism}: no seed exposed the racy twin"
        # the report names its schedule: re-running the seed reproduces
        report = fixture(caught[0], ordered=False)
        assert report["seed"] == caught[0] and report["total"] > 0

    @pytest.mark.parametrize("mechanism", sorted(_PAIRS))
    def test_synchronized_twin_is_clean_under_every_seed(self, mechanism):
        fixture = _PAIRS[mechanism]
        for seed in SEEDS:
            report = fixture(seed, ordered=True)
            assert report["total"] == 0, \
                f"{mechanism}: false positive under seed {seed}: " \
                f"{report['races']}"

    @pytest.mark.parametrize("mechanism", sorted(_PAIRS))
    def test_same_seed_reports_are_byte_identical(self, mechanism):
        fixture = _PAIRS[mechanism]
        for seed in SEEDS[:2]:
            a = json.dumps(fixture(seed, ordered=False), sort_keys=True)
            b = json.dumps(fixture(seed, ordered=False), sort_keys=True)
            assert a == b

    @pytest.mark.parametrize("mechanism", sorted(_PAIRS))
    @pytest.mark.parametrize("ordered", [False, True],
                             ids=["racy", "synchronized"])
    def test_report_json_is_byte_identical_to_jaxs(self, mechanism, ordered):
        """The JAX detector and the port's run the same fixture under the
        same seeds: the same interleavings, so byte-identical reports
        (stacks, locksets, thread names and labels included)."""
        fixture = _PAIRS[mechanism]
        for seed in SEEDS[:3]:
            port = json.dumps(fixture(seed, ordered, R=trace),
                              sort_keys=True)
            jax_ = json.dumps(fixture(seed, ordered, R=jrace),
                              sort_keys=True)
            assert port == jax_, (mechanism, seed)

    def test_locked_counter_is_clean(self):
        # the lockset half of the hybrid, through the full traced stack
        for seed in SEEDS:
            det, sched, ins, box = _cooperative(seed)
            try:
                lock = ins.lock()

                def bump():
                    with lock:
                        box.v = box.v + 1

                _run_threads(sched, ins, bump, bump)
            finally:
                ins.uninstall()
            assert det.report()["total"] == 0

    def test_racy_report_carries_stacks_and_thread_names(self):
        caught = next(s for s in SEEDS
                      if _join_fixture(s, ordered=False)["total"] > 0)
        report = _join_fixture(caught, ordered=False)
        race = report["races"][0]
        assert race["var"].startswith("Box#")
        for side in (race["first"], race["second"]):
            assert side["thread_name"] in ("w1", "w2")
            assert side["stack"], "access stacks must be captured"

    def test_self_test_battery_is_green_and_jaxs(self):
        verdicts = race_cli.run_self_test()
        assert verdicts["ok"], verdicts
        assert verdicts["racy_caught_seeds"]
        from iwae_replication_project_tpu.analysis.race import cli as jcli
        assert verdicts == jcli.run_self_test()


class TestSchedulers:
    def test_deadlock_is_a_verdict_not_a_hang(self):
        det = RaceDetector(capture_stacks=False)
        sched = CooperativeScheduler(0)
        sched.bind(det)
        t0 = time.monotonic()
        with pytest.raises(SchedulerDeadlock):
            sched.run(lambda: sched.block_until(lambda: False))
        assert time.monotonic() - t0 < \
            4 * CooperativeScheduler.DEADLOCK_GRACE_S

    def test_perturb_decision_schedule_is_seed_deterministic_and_jaxs(
            self, monkeypatch):
        def decisions(seed, R=trace):
            det = R.RaceDetector(capture_stacks=False)
            fuzz = R.PerturbFuzzer(seed, rate=0.5, max_sleep_s=0.001)
            fuzz.bind(det)
            rec = []
            monkeypatch.setattr(time, "sleep", rec.append)
            try:
                for _ in range(200):
                    fuzz.on_op("x")
            finally:
                monkeypatch.undo()
            return rec

        assert decisions(3) == decisions(3)
        assert decisions(3) != decisions(4)
        # the JAX fuzzer's per-thread stream, decision for decision
        assert decisions(3) == decisions(3, jrace)

    def test_fuzzer_stamps_its_seed_into_the_report(self):
        det = RaceDetector(capture_stacks=False)
        PerturbFuzzer(17).bind(det)
        assert det.report()["seed"] == 17


# ---------------------------------------------------------------------------
# the instrumented-sync layer: install/uninstall restore contract
# ---------------------------------------------------------------------------

def _fake_module(name="fakemod"):
    import types
    mod = types.ModuleType(name)
    src = textwrap.dedent("""
        import queue
        import threading
        from concurrent.futures import Future
        from dataclasses import dataclass, field

        @dataclass
        class Req:
            future: Future = field(default_factory=Future)

        def make_lock():
            return threading.Lock()

        def make_queue():
            return queue.Queue()
    """)
    exec(compile(src, f"{name}.py", "exec"), mod.__dict__)
    return mod


class TestInstrumentationInstall:
    def test_module_globals_swap_and_exact_restore(self):
        import queue as real_queue
        import threading as real_threading
        from concurrent.futures import Future as RealFuture

        mod = _fake_module()
        ins = Instrumentation(RaceDetector(capture_stacks=False))
        try:
            ins.install(modules=(mod,))
            assert mod.threading is ins.threading
            assert mod.queue is ins.queue
            assert mod.Future is ins.future_cls
            assert type(mod.make_lock()).__name__ == "_TracedLock"
            assert type(mod.make_queue()).__name__ == "TracedQueue"
        finally:
            ins.uninstall()
        assert mod.threading is real_threading
        assert mod.queue is real_queue
        assert mod.Future is RealFuture
        assert type(mod.make_lock()) is type(real_threading.Lock())

    def test_dataclass_default_factory_swap_reaches_the_closure(self):
        # field(default_factory=Future) bakes the REAL class into the
        # generated __init__'s closure at class-definition time; the install
        # patches the Field AND the closure cell, the uninstall restores both
        from concurrent.futures import Future as RealFuture

        mod = _fake_module()
        ins = Instrumentation(RaceDetector(capture_stacks=False))
        try:
            ins.install(modules=(mod,))
            assert type(mod.Req().future) is ins.future_cls
        finally:
            ins.uninstall()
        assert type(mod.Req().future) is RealFuture
        assert mod.Req.__dataclass_fields__["future"].default_factory \
            is RealFuture
        for cell in mod.Req.__init__.__closure__ or ():
            v = cell.cell_contents
            assert not (isinstance(v, type) and issubclass(v, RealFuture)
                        and v is not RealFuture)

    def test_class_hooks_install_and_vanish_on_uninstall(self):
        class Plain:
            pass

        ins = Instrumentation(RaceDetector(capture_stacks=False))
        try:
            ins.track(Plain())
            assert "__setattr__" in vars(Plain)
            assert "__getattribute__" in vars(Plain)
        finally:
            ins.uninstall()
        assert "__setattr__" not in vars(Plain)
        assert "__getattribute__" not in vars(Plain)

    def test_slotted_store_classes_are_traced_and_restored(self):
        # the store's entry and pin handles use __slots__: reads are found
        # through the slots, and the hooks vanish on uninstall
        from iwae_replication_project_tpu_torch.utils import compile_cache
        det = RaceDetector(capture_stacks=False)
        ins = Instrumentation(det)
        classes = (compile_cache._StoreEntry, compile_cache._PrefixPin)
        try:
            ins.install(classes=classes)
            e = compile_cache._StoreEntry(object(), 8)
            assert e.pins == 0
        finally:
            ins.uninstall()
        assert {"_StoreEntry#0.bytes", "_StoreEntry#0.pins"} <= \
            set(det._vars)
        for cls in classes:
            assert "__setattr__" not in vars(cls)

    def test_sync_valued_and_private_attrs_are_not_data(self):
        # reading the lock handle off an object IS synchronization; tracing
        # it would flag every guarded class on its own lock attribute
        det = RaceDetector(capture_stacks=False)
        ins = Instrumentation(det)

        class Holder:
            pass

        h = ins.track(Holder())
        try:
            h.lock = threading.Lock()
            h._race_scratch = 1
            h.n = 1
        finally:
            ins.uninstall()
        assert "Holder#0.n" in det._vars
        assert not any(v.endswith(".lock") for v in det._vars)
        assert not any("_race_" in v for v in det._vars)

    def test_active_context_manager_uninstalls_on_error(self):
        import threading as real_threading

        mod = _fake_module()
        ins = Instrumentation(RaceDetector(capture_stacks=False))
        with pytest.raises(RuntimeError):
            with ins.active(modules=(mod,)):
                assert mod.threading is ins.threading
                raise RuntimeError("boom")
        assert mod.threading is real_threading


# ---------------------------------------------------------------------------
# the port's engine and tier under the instrumentation
# ---------------------------------------------------------------------------

D = 32


def _tiny(max_batch):
    """An engine factory at test width on the CPU."""
    from iwae_replication_project_tpu_torch.models import iwae as model
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)

    cfg = model.ModelConfig(x_dim=D, n_hidden_enc=(16, 8),
                            n_latent_enc=(8, 4), n_hidden_dec=(8, 16),
                            n_latent_dec=(8, D))
    params = model.init_params(torch.Generator().manual_seed(0), cfg)

    def engine():
        return ServingEngine(params=params, model_config=cfg, k=4,
                             max_batch=max_batch, max_inflight=2,
                             timeout_s=30.0, device="cpu")
    return engine


def _rows(n, seed=0):
    return (np.random.RandomState(seed).rand(n, D) > 0.5).astype(np.float32)


class TestEngineParity:
    def test_instrumented_engine_is_bitwise_identical_and_race_clean(self):
        from concurrent.futures import Future as RealFuture

        from iwae_replication_project_tpu_torch.serving import (
            batcher as mod_batcher)
        from iwae_replication_project_tpu_torch.serving import (
            engine as mod_engine)

        engine = _tiny(8)
        x = _rows(6)

        def run(instrumented, seed=0):
            ins = None
            if instrumented:
                ins = Instrumentation(RaceDetector(stack_depth=4),
                                      PerturbFuzzer(seed, rate=0.25,
                                                    max_sleep_s=0.001))
                ins.install(
                    modules=(mod_engine, mod_batcher),
                    classes=(mod_engine.ServingEngine,
                             mod_batcher.MicroBatcher,
                             mod_batcher.InflightWindow))
            try:
                eng = engine()
                eng.warmup(ops=("score",))
                out = eng.score(x)
                eng.stop()
            finally:
                if ins is not None:
                    ins.uninstall()
            return out, (ins.det.report() if ins else None)

        ref, _ = run(instrumented=False)
        on, report = run(instrumented=True)
        assert report["total"] == 0, report["races"][:2]
        assert np.array_equal(on, ref), \
            "instrumentation must observe, never perturb results"
        off, _ = run(instrumented=False)
        assert np.array_equal(off, ref), \
            "post-uninstall engine differs from the pre-install one"
        assert mod_batcher.Request.__dataclass_fields__[
            "future"].default_factory is RealFuture
        assert type(mod_batcher.Request(
            op="score", payload=None, k=1, seed=0, t_enqueue=0.0,
            deadline=None).future) is RealFuture


#: the CPU sweep's schedules (the card's race phase runs >= 20)
SWEEP_SEEDS = (0, 1, 2, 3)


class TestTierSweep:
    def test_fuzzed_tier_sweep_holds_the_four_contracts(self):
        """Two replicas behind the tier over TCP, the first killed
        mid-burst, under the detector and a PerturbFuzzer per seed:
        (1) no race, (2) no open span, pinned store entry or outstanding
        router future after the drain, (3) rows bitwise one direct engine's,
        (4) every patched global and class hook the original after the
        sweep. The engines coalesce the burst's requests (max batch 8):
        a row's bits are the same in every bucket, on the CPU as on the
        card."""
        engine = _tiny(8)
        x = _rows(sum(tier_sweep.SIZES))
        modules = tier_sweep.serving_modules()
        classes = tier_sweep.tracked_classes()
        before = tier_sweep.patchables(modules)
        ref = tier_sweep.direct_rows(engine, x)
        base = tier_sweep.run_round(engine, x, None)
        assert tier_sweep.round_problems(base, ref) == []
        dispatches = [base.dispatches]
        for seed in SWEEP_SEEDS:
            r = tier_sweep.run_round(engine, x, seed)
            assert r.report["seed"] == seed
            assert tier_sweep.round_problems(r, ref) == []
            # every row served, at most 8 a dispatch
            assert r.dispatches >= -(-len(x) // 8)
            dispatches.append(r.dispatches)
        # the burst's multi-row requests rode coalesced dispatches
        assert min(dispatches) < len(x), dispatches
        assert tier_sweep.uninstall_problems(modules, classes, before) == []

    def test_a_round_store_has_a_traced_lock_and_is_restored(self):
        from iwae_replication_project_tpu_torch.utils import compile_cache
        saved = compile_cache.executable_store()
        ins = Instrumentation(RaceDetector(capture_stacks=False))
        try:
            ins.install(modules=(compile_cache,))
            with tier_sweep.round_store() as store:
                assert compile_cache.executable_store() is store
                assert type(store._lock).__name__ == "_TracedRLock"
        finally:
            ins.uninstall()
        assert compile_cache.executable_store() is saved
        assert type(saved._lock) is type(threading.RLock())

    def test_uninstall_problems_name_a_left_hook(self):
        class Plain:
            pass

        ins = Instrumentation(RaceDetector(capture_stacks=False))
        modules = tier_sweep.serving_modules()
        before = tier_sweep.patchables(modules)
        try:
            ins.install(modules=modules, classes=(Plain,))
            left = tier_sweep.uninstall_problems(modules, (Plain,), before)
        finally:
            ins.uninstall()
        assert "patched module globals left behind" in left
        assert any("Plain" in p for p in left)
        assert tier_sweep.uninstall_problems(modules, (Plain,), before) == []


# ---------------------------------------------------------------------------
# static thread-escape analysis
# ---------------------------------------------------------------------------

def _classify(src, skip=()):
    tree = ast.parse(textwrap.dedent(src))
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef))
    return classify_class(cls, skip_attrs=set(skip))


class TestEscapeAnalysis:
    #: appended to CONFINED at the class-body indent level (before dedent)
    READ_N = ("\n            def read(self):\n"
              "                return self.n\n")

    CONFINED = """
        import threading

        class Worker:
            def __init__(self):
                self.n = 0

            def start(self):
                self.t = threading.Thread(target=self._loop)
                self.t.start()

            def _loop(self):
                self.n = self.n + 1
    """

    def test_single_thread_root_attr_is_confined(self):
        esc = _classify(self.CONFINED)
        assert esc.roots_of("n") == {"thread:_loop"}
        assert esc.confined("n")
        assert not esc.escaping("n")

    def test_external_reader_makes_it_escape(self):
        esc = _classify(self.CONFINED + self.READ_N)
        assert esc.roots_of("n") == {"thread:_loop", escape.EXTERNAL}
        assert esc.escaping("n") and not esc.confined("n")

    def test_reachability_follows_same_class_calls(self):
        esc = _classify("""
            import threading

            class W:
                def start(self):
                    threading.Thread(target=self._loop).start()

                def _loop(self):
                    self._step()

                def _step(self):
                    self.n = 1
        """)
        assert "thread:_loop" in esc.roots_of("n")

    def test_done_callback_is_a_thread_root(self):
        esc = _classify("""
            class W:
                def arm(self, fut):
                    fut.add_done_callback(self._on_done)

                def _on_done(self, f):
                    self.done = True

                def poll(self):
                    return self.done
        """)
        assert esc.roots_of("done") == {"thread:_on_done", escape.EXTERNAL}
        assert esc.escaping("done")

    def test_queue_put_payload_is_a_handoff(self):
        esc = _classify("""
            class W:
                def push(self, q):
                    q.put(self.buf)
        """)
        assert escape.HANDOFF in esc.roots_of("buf")
        assert esc.escaping("buf")

    def test_thread_args_payload_is_a_handoff(self):
        esc = _classify("""
            import threading

            class W:
                def start(self):
                    threading.Thread(target=self._loop,
                                     args=(self.shared,)).start()

                def _loop(self, shared):
                    pass
        """)
        assert escape.HANDOFF in esc.roots_of("shared")

    def test_skip_attrs_hide_lock_attributes(self):
        esc = _classify(self.CONFINED + self.READ_N, skip=("n",))
        assert esc.roots_of("n") == {escape.EXTERNAL}   # the default

    def test_external_only_attr_neither_confined_nor_escaping(self):
        esc = _classify("""
            class W:
                def set(self, v):
                    self.v = v

                def get(self):
                    return self.v
        """)
        assert esc.roots_of("v") == {escape.EXTERNAL}
        assert not esc.confined("v") and not esc.escaping("v")

    def test_port_serving_classes_classify_as_jaxs_do(self):
        """The port's escape pass and JAX's agree on every class of the
        port's engine, batcher and router sources."""
        from iwae_replication_project_tpu.analysis.race import (
            escape as jescape)
        for rel in ("serving/engine.py", "serving/batcher.py",
                    "serving/frontend/router.py"):
            tree = ast.parse(open(os.path.join(REPO, PORT_PKG, rel)).read())
            for cls in [n for n in ast.walk(tree)
                        if isinstance(n, ast.ClassDef)]:
                a = classify_class(cls)
                b = jescape.classify_class(cls)
                assert (a.roots, a.attr_roots, a.written) == \
                    (b.roots, b.attr_roots, b.written), (rel, cls.name)


# ---------------------------------------------------------------------------
# the escape-aware unlocked-shared-state rule and the static leak pass,
# through the lint framework (and JAX's, on the same sources)
# ---------------------------------------------------------------------------

def _lint(tmp_path, src, rel, jax_too=False, **config_over):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    got = lint_paths([str(path)], LintConfig(root=str(tmp_path),
                                             **config_over),
                     root=str(tmp_path))
    if jax_too:
        want = janalysis.lint_paths(
            [str(path)], janalysis.LintConfig(root=str(tmp_path),
                                              **config_over),
            root=str(tmp_path))
        assert [(f.rule, f.line, f.col, f.message) for f in got] == \
            [(f.rule, f.line, f.col, f.message) for f in want]
    return got


def _rules(findings):
    return [f.rule for f in findings]


class TestEscapeAwareLint:
    ESCAPING = """
        import threading

        class Worker:
            def __init__(self):
                self.n = 0

            def start(self):
                self.t = threading.Thread(target=self._loop)
                self.t.start()

            def _loop(self):
                self.n = self.n + 1

            def read(self):
                return self.n
    """

    def lint(self, tmp_path, src):
        return _lint(tmp_path, src, rel="conc/m.py", jax_too=True,
                     concurrency_paths=["conc"],
                     select=["unlocked-shared-state"])

    def test_never_guarded_escaping_write_fires(self, tmp_path):
        got = self.lint(tmp_path, self.ESCAPING)
        assert "unlocked-shared-state" in _rules(got)
        assert "escapes to multiple thread roots" in got[0].message

    def test_thread_confined_write_is_clean(self, tmp_path):
        confined = self.ESCAPING.replace(
            "            def read(self):\n"
            "                return self.n\n", "")
        assert self.lint(tmp_path, confined) == []


BAD_SPAN = """
    def handle(tracer, risky):
        span = tracer.start_span("req")
        risky()
        span.finish()
"""

GOOD_SPAN_FINALLY = """
    def handle(tracer, risky):
        span = tracer.start_span("req")
        try:
            risky()
        finally:
            span.finish()
"""

GOOD_SPAN_STRAIGHT_LINE = """
    def handle(tracer):
        span = tracer.start_span("req")
        ok = True
        span.finish()
        return ok
"""

NEVER_SUNK_SPAN = """
    def handle(tracer):
        span = tracer.start_span("req")
        return None
"""

DROPPED_FUTURE = """
    from concurrent.futures import Future

    def submit():
        Future()
"""

BAD_FUTURE = """
    from concurrent.futures import Future

    def submit(work):
        f = Future()
        work.validate()
        f.set_result(1)
        return f
"""

GOOD_FUTURE_EXCEPT_ALL = """
    from concurrent.futures import Future

    def submit(work):
        f = Future()
        try:
            work.run()
        except Exception as e:
            f.set_exception(e)
            raise
        f.set_result(1)
        return f
"""

GOOD_FUTURE_STORED_AT_BIRTH = """
    from concurrent.futures import Future

    def submit(self, key):
        self.pending[key] = Future()
"""

BAD_PIN = """
    def score(store, sig, xs):
        pin = store.pin_prefix(sig)
        out = xs.sum()
        pin.release()
        return out
"""

GOOD_PIN = """
    def score(store, sig, xs):
        pin = store.pin_prefix(sig)
        try:
            return run(pin, xs)
        finally:
            pin.release()
"""

# the port's fleet takes model pins at placement, stored at birth
MODEL_PIN_STORED = """
    def place(self, store, models):
        for model in models:
            self._pins.append(store.pin_model(model))
"""

SUPPRESSED_SPAN = """
    def handle(tracer, risky):
        span = tracer.start_span("req")  # iwaelint: disable=leaked-span -- risky() is exception-free by construction (pure dict lookup); the straight-line finish below always runs
        risky()
        span.finish()
"""

FUTURE_WITH_CTOR_ARGS = """
    def submit(x):
        f = Future(x)
        work()
"""

#: (source, the leak rules it fires)
LEAK_CASES = {
    "bad_span": (BAD_SPAN, ["leaked-span"]),
    "good_span_finally": (GOOD_SPAN_FINALLY, []),
    "good_span_straight_line": (GOOD_SPAN_STRAIGHT_LINE, []),
    "never_sunk_span": (NEVER_SUNK_SPAN, ["leaked-span"]),
    "dropped_future": (DROPPED_FUTURE, ["leaked-future"]),
    "bad_future": (BAD_FUTURE, ["leaked-future"]),
    "good_future_except_all": (GOOD_FUTURE_EXCEPT_ALL, []),
    "good_future_stored_at_birth": (GOOD_FUTURE_STORED_AT_BIRTH, []),
    "bad_pin": (BAD_PIN, ["leaked-pin"]),
    "good_pin": (GOOD_PIN, []),
    "model_pin_stored": (MODEL_PIN_STORED, []),
    "suppressed_span": (SUPPRESSED_SPAN, []),
    "future_with_ctor_args": (FUTURE_WITH_CTOR_ARGS, []),
}

LEAK_RULES = ["leaked-future", "leaked-span", "leaked-pin"]


class TestLeakPass:
    @pytest.mark.parametrize("case", sorted(LEAK_CASES))
    def test_leak_case_and_jax_parity(self, case, tmp_path):
        src, want = LEAK_CASES[case]
        got = _lint(tmp_path, src, rel="leak/m.py", jax_too=True,
                    leak_paths=["leak"], select=LEAK_RULES)
        assert _rules(got) == want

    def test_messages_name_the_failure(self, tmp_path):
        def lint(src):
            return _lint(tmp_path, src, rel="leak/m.py",
                         leak_paths=["leak"], select=LEAK_RULES)
        assert "leaks if line" in lint(BAD_SPAN)[0].message
        assert "never completed" in lint(NEVER_SUNK_SPAN)[0].message
        assert "never bound" in lint(DROPPED_FUTURE)[0].message

    def test_shipped_leak_paths_are_clean(self):
        cfg, src = load_config(REPO)
        assert src is None and cfg.root == REPO   # no [tool.iwaelint_torch]
        cfg.select = list(LEAK_RULES)
        assert lint_paths(cfg.leak_paths, cfg, root=REPO) == []


# ---------------------------------------------------------------------------
# CLI exit contract
# ---------------------------------------------------------------------------

class TestRaceCli:
    def _run(self, *args, cwd=REPO):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.run(
            [sys.executable, "-m", f"{PORT_PKG}.analysis.race", *args],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=300)

    def _leak_tree(self, tmp_path, src):
        # --no-config uses the built-in leak_paths; mirror one of them
        # under a scratch root so the rules are in scope for the file
        rel = f"{PORT_PKG}/serving/engine.py"
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
        return rel

    def test_clean_file_exits_0(self, tmp_path):
        rel = self._leak_tree(tmp_path, "x = 1\n")
        r = self._run("--no-config", rel, cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert "leak pass clean" in r.stdout

    def test_findings_exit_1_with_json(self, tmp_path):
        rel = self._leak_tree(tmp_path, BAD_SPAN)
        r = self._run("--no-config", "--format", "json", rel, cwd=tmp_path)
        assert r.returncode == 1, r.stderr
        payload = json.loads(r.stdout)
        assert payload["counts"] == {"leaked-span": 1}

    def test_missing_path_exits_2(self, tmp_path):
        r = self._run("--no-config", "does_not_exist.py", cwd=tmp_path)
        assert r.returncode == 2
        assert "error" in r.stderr

    def test_list_rules_exits_0(self):
        r = self._run("--list-rules")
        assert r.returncode == 0
        for rule in LEAK_RULES:
            assert rule in r.stdout

    def test_self_test_reports_verdicts_in_json(self, tmp_path):
        rel = self._leak_tree(tmp_path, "x = 1\n")
        r = self._run("--no-config", "--self-test", "--format", "json",
                      rel, cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        st = json.loads(r.stdout)["self_test"]
        assert st["ok"] and st["racy_caught_seeds"] == list(SEEDS)

    def test_shipped_tree_is_clean_via_configured_paths(self):
        r = self._run("--self-test")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "leak pass clean" in r.stdout
        assert "self-test ok" in r.stdout

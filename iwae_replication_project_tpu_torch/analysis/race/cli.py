"""``iwae-race``: the race-detector CLI.

``python -m iwae_replication_project_tpu_torch.analysis.race [paths]`` runs the
**static leak pass** (``leaked-future`` / ``leaked-span`` / ``leaked-pin``,
see :mod:`.leaks`) over the configured ``leak_paths`` — the serving control
plane's future/span/pin acquisition sites — with the shared lint
framework's suppression grammar and config.

``--self-test`` additionally runs the **dynamic detector battery**: the
lockset + happens-before detector (:mod:`.model`) driven by the
cooperative seeded scheduler (:mod:`.fuzz`) over built-in fixture pairs —
a racy counter that MUST be caught (with a reproducing seed), its locked
and HB-ordered twins that MUST stay clean, and a same-seed determinism
check (two runs, byte-identical reports). A battery failure means the
detector itself is broken and exits 2 (internal error), never 1: a broken
detector must not masquerade as a findings list.

Exit codes (the lint CLI's contract): 0 = clean, 1 = findings,
2 = usage/config/internal error. ``--format json`` emits one
machine-readable object (findings + counts + self-test verdicts).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Dict, List, Optional

from iwae_replication_project_tpu_torch.analysis import core
from iwae_replication_project_tpu_torch.analysis.config import (
    LintConfig,
    load_config,
)

_LEAK_RULES = ["leaked-future", "leaked-span", "leaked-pin"]

#: seeds the self-test battery schedules the racy fixture under; the racy
#: write pair is adjacent in program order, so nearly any preemption at
#: the access yield points exposes it — a handful of seeds is plenty
_SELF_TEST_SEEDS = (0, 1, 2, 3, 4)


# ---------------------------------------------------------------------------
# the dynamic self-test battery (fixtures built from the instrumented-sync
# layer itself: the detector checks the detector)
# ---------------------------------------------------------------------------

def _run_fixture(seed: int, variant: str) -> dict:
    """One cooperative scheduled run of the named fixture variant; returns
    the detector's deterministic report."""
    from iwae_replication_project_tpu_torch.analysis.race import (
        CooperativeScheduler,
        Instrumentation,
        RaceDetector,
    )

    det = RaceDetector()
    sched = CooperativeScheduler(seed)
    sched.bind(det)
    ins = Instrumentation(detector=det, fuzz=sched)

    class Shared:
        def __init__(self):
            self.n = 0

    obj = Shared()
    ins.track(obj)
    lock = ins.lock()

    def bump_racy():
        obj.n = obj.n + 1

    def bump_locked():
        with lock:
            obj.n = obj.n + 1

    def driver():
        body = bump_locked if variant == "locked" else bump_racy
        t1 = ins.thread(target=body, name="w1")
        t2 = ins.thread(target=body, name="w2")
        if variant == "hb":
            # join before the second start: the join edge orders the pair
            t1.start()
            t1.join()
            t2.start()
            t2.join()
        else:
            t1.start()
            t2.start()
            t1.join()
            t2.join()

    sched.run(driver)
    return det.report()


def run_self_test() -> Dict[str, object]:
    """The battery. Returns a verdict dict; ``ok`` False = detector broken."""
    verdicts: Dict[str, object] = {}
    caught_seeds = []
    for seed in _SELF_TEST_SEEDS:
        if _run_fixture(seed, "racy")["total"] > 0:
            caught_seeds.append(seed)
    verdicts["racy_caught_seeds"] = caught_seeds
    verdicts["racy_caught"] = len(caught_seeds) > 0
    verdicts["locked_clean"] = all(
        _run_fixture(seed, "locked")["total"] == 0
        for seed in _SELF_TEST_SEEDS)
    verdicts["hb_clean"] = all(
        _run_fixture(seed, "hb")["total"] == 0
        for seed in _SELF_TEST_SEEDS)
    if caught_seeds:
        seed = caught_seeds[0]
        a = json.dumps(_run_fixture(seed, "racy"), sort_keys=True)
        b = json.dumps(_run_fixture(seed, "racy"), sort_keys=True)
        verdicts["deterministic"] = a == b
    else:
        verdicts["deterministic"] = False
    verdicts["ok"] = bool(verdicts["racy_caught"] and
                          verdicts["locked_clean"] and
                          verdicts["hb_clean"] and
                          verdicts["deterministic"])
    return verdicts


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.analysis.race",
        description="iwae-race: static future/span/pin leak pass over the "
                    "serving control plane, plus the lockset+happens-before "
                    "detector's self-test battery.")
    p.add_argument("paths", nargs="*",
                   help="files/directories for the leak pass (default: the "
                        "config's leak_paths)")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--list-rules", action="store_true",
                   help="print the leak-pass rules and exit")
    p.add_argument("--self-test", action="store_true",
                   help="also run the dynamic detector battery (exit 2 on "
                        "battery failure: a broken detector is an internal "
                        "error, not a findings list)")
    p.add_argument("--no-config", action="store_true",
                   help="ignore [tool.iwaelint_torch]; built-in defaults "
                        "only")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.no_config:
            config, src = LintConfig(), None
        else:
            config, src = load_config()
        config.select = list(_LEAK_RULES)

        if args.list_rules:
            rules = core.all_rules()
            width = max(len(n) for n in _LEAK_RULES)
            for name in _LEAK_RULES:
                print(f"{name:<{width}}  {rules[name].summary}")
            return 0

        paths = args.paths or config.leak_paths
        findings = core.lint_paths(paths, config)
        self_test = run_self_test() if args.self_test else None
    except (ValueError, FileNotFoundError) as e:
        print(f"iwae-race: error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        payload = {
            "findings": [f.to_dict() for f in findings],
            "counts": dict(Counter(f.rule for f in findings)),
            "total": len(findings),
            "config": src,
        }
        if self_test is not None:
            payload["self_test"] = self_test
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(f.human())
        if findings:
            tally = ", ".join(
                f"{rule}: {n}" for rule, n in
                sorted(Counter(f.rule for f in findings).items()))
            print(f"\n{len(findings)} finding(s) ({tally})")
        else:
            print("iwae-race: leak pass clean")
        if self_test is not None:
            print(f"iwae-race: self-test "
                  f"{'ok' if self_test['ok'] else 'FAILED'} "
                  f"(racy caught under seeds "
                  f"{self_test['racy_caught_seeds']}, locked twin "
                  f"{'clean' if self_test['locked_clean'] else 'DIRTY'}, "
                  f"hb twin "
                  f"{'clean' if self_test['hb_clean'] else 'DIRTY'}, "
                  f"same-seed report "
                  f"{'byte-identical' if self_test['deterministic'] else 'DIVERGED'})")
    if self_test is not None and not self_test["ok"]:
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

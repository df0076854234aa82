"""``iwae-prof``: the statistical perf-regression gate over benchmark
artifacts (port of ``analysis/regress.py``).

    python -m iwae_replication_project_tpu_torch.analysis.regress \
        --diff results/perf_baseline.json results/*_bench.json
    python -m iwae_replication_project_tpu_torch.analysis.regress \
        --collect results/*_bench.json --out results/perf_baseline.json

The module is the JAX package's, line for line in its logic: it reads
JSON and uses only the standard library, so the port keeps its own copy
rather than importing the JAX package. It diffs any pair of artifacts:
JAX's committed ``results/*_bench.json`` against
``results/perf_baseline.json``, and the JSON documents the port's card
scripts write.

* every numeric leaf in a pair of artifacts is a candidate metric; keys
  whose names carry a direction (``*_seconds``/``wall``/``overhead``/
  ``latency`` are lower-better, ``*_per_sec``/``throughput``/``speedup``
  higher-better) are compared, everything else (config echo, counters of
  unknown polarity) is skipped AND counted — a silent skip would read as
  "covered";
* numeric LISTS are treated as paired-rep spreads: the comparison is
  median-vs-median, gated by a two-sided rank-sum test (Mann-Whitney
  normal approximation with tie correction);
* the **noise floor** is learned from the artifacts themselves: the
  relative IQR of the metric's own spread and of sibling spreads under
  the same JSON parent, floored at ``--min-rel``. A scalar-only metric
  must clear the wider ``--scalar-min-rel`` bar instead of a
  significance test;
* a **regression** is a bad-direction median shift that clears the noise
  floor AND (when both sides have >= 3 reps) the rank test at
  ``--alpha``. Improvements are reported but never gate.

Exit codes: 0 = no regressions, 1 = at least one regression (each
finding names the artifact and the metric key), 2 = usage/internal
error. ``--json`` emits the JAX tools' shared envelope (``{"tool",
"schema", "mode", "ok", "findings", "data"}``) with the same tool name,
so the two packages' findings compare as documents.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "ENVELOPE_SCHEMA",
    "BASELINE_KIND",
    "make_envelope",
    "extract_metrics",
    "direction_for",
    "rank_sum_p",
    "diff_artifacts",
    "diff_bundles",
    "collect_bundle",
    "main",
]

#: version of the shared ``--json`` CLI envelope (iwae-prof AND iwae-trace)
ENVELOPE_SCHEMA = 1

#: ``kind`` tag of a --collect bundle (results/perf_baseline.json)
BASELINE_KIND = "iwae-perf-baseline"


def make_envelope(tool: str, mode: str, *, ok: bool,
                  findings: Sequence[dict] = (), data=None) -> dict:
    """The one ``--json`` output convention every iwae observability CLI
    shares: tool name, envelope schema version, the subcommand that ran,
    an overall ok bit, typed findings, and the tool-specific payload."""
    return {"tool": str(tool), "schema": ENVELOPE_SCHEMA,
            "mode": str(mode), "ok": bool(ok),
            "findings": list(findings), "data": data}


# -- metric extraction -------------------------------------------------------

def extract_metrics(doc, prefix: str = "") -> Dict[str, List[float]]:
    """Flatten an artifact to ``slash/path -> samples``.

    A numeric scalar becomes a 1-sample series; a homogeneous numeric
    list becomes its recorded spread (the benches' ``*_pairs`` / per-rep
    arrays — the raw material for both the rank test and the noise
    floor). Bools are config, not metrics. List-of-dict elements keep
    their index in the path so sweep rows stay distinct keys."""
    out: Dict[str, List[float]] = {}

    def _num(v) -> bool:
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    def walk(node, path):
        if _num(node):
            out[path] = [float(node)]
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, list):
            if node and all(_num(v) for v in node):
                out[path] = [float(v) for v in node]
            else:
                for i, v in enumerate(node):
                    walk(v, f"{path}[{i}]")

    walk(doc, prefix)
    return out


def direction_for(key: str) -> int:
    """-1 = lower is better, +1 = higher is better, 0 = unknown (skip).

    Polarity lives in the leaf name, by the repo's bench conventions.
    The higher-better tokens are checked first so ``rows_per_sec`` does
    not fall into the ``_sec`` suffix trap."""
    leaf = key.rsplit("/", 1)[-1].lower()
    for tok in ("per_sec", "per_second", "throughput", "speedup"):
        if tok in leaf:
            return 1
    if leaf.endswith(("_s", "_sec", "_seconds", "_us", "_ms", "_ns")) \
            or "seconds" in leaf or "latency" in leaf \
            or "overhead" in leaf or "wall" in leaf:
        return -1
    return 0


# -- statistics (standard library only) --------------------------------------

def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _quantile(xs: Sequence[float], q: float) -> float:
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (pos - lo) * (s[hi] - s[lo])


def _rel_iqr(xs: Sequence[float]) -> float:
    """Relative interquartile range — the spread-derived noise unit."""
    if len(xs) < 2:
        return 0.0
    med = _median(xs)
    if abs(med) < 1e-12:
        return 0.0
    return (_quantile(xs, 0.75) - _quantile(xs, 0.25)) / abs(med)


def rank_sum_p(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sided Mann-Whitney rank-sum p-value, normal approximation
    with tie correction and continuity correction.

    Exact for our purposes (bench reps are n ~ 5-12; the gate only needs
    "is this shift distinguishable from rep noise", not a publication
    p-value). Returns 1.0 when every observation ties (zero variance —
    nothing is distinguishable)."""
    n1, n2 = len(a), len(b)
    if n1 == 0 or n2 == 0:
        return 1.0
    pooled = sorted((v, 0) for v in a) + sorted((v, 1) for v in b)
    pooled.sort(key=lambda t: t[0])
    # average ranks over tie groups
    ranks = [0.0] * len(pooled)
    tie_term = 0.0
    i = 0
    while i < len(pooled):
        j = i
        while j + 1 < len(pooled) and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[k] = avg
        t = j - i + 1
        tie_term += t ** 3 - t
        i = j + 1
    r1 = sum(r for r, (_, side) in zip(ranks, pooled) if side == 0)
    u = r1 - n1 * (n1 + 1) / 2.0
    mu = n1 * n2 / 2.0
    n = n1 + n2
    var = (n1 * n2 / 12.0) * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0:
        return 1.0
    z = (abs(u - mu) - 0.5) / math.sqrt(var)
    if z < 0:
        z = 0.0
    return max(0.0, min(1.0, 2.0 * (1.0 - 0.5 * (1.0 + math.erf(
        z / math.sqrt(2.0))))))


# -- the diff ---------------------------------------------------------------

def _sibling_noise(path: str, *metric_maps: Dict[str, List[float]]) -> float:
    """Noise floor for the metric at ``path`` from recorded spreads: the
    metric's own reps plus any >=3-sample series under the same JSON
    parent (the benches put ``*_pairs`` next to the medians they
    support)."""
    parent = path.rsplit("/", 1)[0] if "/" in path else ""
    noise = 0.0
    for metrics in metric_maps:
        own = metrics.get(path)
        if own is not None:
            noise = max(noise, _rel_iqr(own))
        for k, xs in metrics.items():
            if len(xs) >= 3 and \
                    (k.rsplit("/", 1)[0] if "/" in k else "") == parent:
                noise = max(noise, _rel_iqr(xs))
    return noise


def diff_artifacts(old_doc, new_doc, *, artifact: str = "",
                   alpha: float = 0.05, min_rel: float = 0.05,
                   scalar_min_rel: float = 0.10
                   ) -> Tuple[List[dict], dict]:
    """Compare two artifacts; return (findings, stats).

    Findings are regressions only (``kind: "perf/regression"``);
    improvements and skips land in stats. Each finding names the
    artifact and the full metric key — the "program" the gate flags."""
    old_m = extract_metrics(old_doc)
    new_m = extract_metrics(new_doc)
    findings: List[dict] = []
    stats = {"compared": 0, "skipped_unknown_direction": 0,
             "skipped_zero_baseline": 0, "only_old": 0, "only_new": 0,
             "improvements": []}
    for key in sorted(old_m):
        if key not in new_m:
            stats["only_old"] += 1
            continue
        direction = direction_for(key)
        if direction == 0:
            stats["skipped_unknown_direction"] += 1
            continue
        old_xs, new_xs = old_m[key], new_m[key]
        old_med, new_med = _median(old_xs), _median(new_xs)
        if abs(old_med) < 1e-12:
            stats["skipped_zero_baseline"] += 1
            continue
        stats["compared"] += 1
        rel = (new_med - old_med) / abs(old_med)
        bad = rel > 0 if direction < 0 else rel < 0
        mag = abs(rel)
        noise = _sibling_noise(key, old_m, new_m)
        paired = len(old_xs) >= 3 and len(new_xs) >= 3
        p = rank_sum_p(old_xs, new_xs) if paired else None
        if paired:
            floor = max(noise, min_rel)
            is_reg = bad and mag > floor and p < alpha
        else:
            floor = max(noise, scalar_min_rel)
            is_reg = bad and mag > floor
        record = {
            "artifact": artifact, "key": key,
            "old_median": old_med, "new_median": new_med,
            "rel_change": rel, "noise_floor": floor,
            "p_value": p, "n_old": len(old_xs), "n_new": len(new_xs),
        }
        if is_reg:
            record["kind"] = "perf/regression"
            findings.append(record)
        elif not bad and mag > floor and (p is None or p < alpha):
            stats["improvements"].append(record)
    stats["only_new"] = sum(1 for k in new_m if k not in old_m)
    return findings, stats


def collect_bundle(paths: Sequence[str]) -> dict:
    """Bundle artifacts into a baseline document keyed by filename stem
    (``results/tracing_bench.json`` -> ``tracing_bench``)."""
    artifacts = {}
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            artifacts[_stem(p)] = json.load(f)
    return {"kind": BASELINE_KIND, "schema": ENVELOPE_SCHEMA,
            "artifacts": artifacts}


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _load_side(paths: Sequence[str]) -> Dict[str, dict]:
    """One diff side: each path is either a --collect bundle (its
    artifacts merge in under their own stems) or a bare artifact (keyed
    by its filename stem) — so ``--diff baseline.json results/*_bench
    .json`` and ``--diff old.json new.json`` both just work."""
    out: Dict[str, dict] = {}
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get("kind") == BASELINE_KIND:
            out.update(doc.get("artifacts", {}))
        else:
            out[_stem(p)] = doc
    return out


def diff_bundles(old: Dict[str, dict], new: Dict[str, dict], *,
                 alpha: float = 0.05, min_rel: float = 0.05,
                 scalar_min_rel: float = 0.10) -> Tuple[List[dict], dict]:
    """Diff every artifact stem present on BOTH sides; stems on one side
    only are counted (a new bench has no baseline yet — not a failure,
    but not silent either)."""
    findings: List[dict] = []
    per_artifact: Dict[str, dict] = {}
    shared = sorted(set(old) & set(new))
    for name in shared:
        # when the two sides are literally the same document, short-
        # circuit: identical is identical, no statistics needed
        if old[name] == new[name]:
            per_artifact[name] = {"identical": True, "compared": 0}
            continue
        f, stats = diff_artifacts(old[name], new[name], artifact=name,
                                  alpha=alpha, min_rel=min_rel,
                                  scalar_min_rel=scalar_min_rel)
        findings.extend(f)
        per_artifact[name] = stats
    stats = {
        "artifacts_compared": len(shared),
        "artifacts_only_old": sorted(set(old) - set(new)),
        "artifacts_only_new": sorted(set(new) - set(old)),
        "per_artifact": per_artifact,
    }
    return findings, stats


# -- CLI --------------------------------------------------------------------

def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="iwae-prof",
        description="profiling-plane CLI: statistical perf-regression "
                    "gate over bench artifacts, and baseline collection")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--diff", nargs="+", metavar="PATH",
                      help="OLD NEW [NEW...]: diff the first artifact/"
                           "bundle against the rest; exit 1 on any "
                           "statistically significant regression")
    mode.add_argument("--collect", nargs="+", metavar="PATH",
                      help="bundle artifacts into a baseline document "
                           "(write with --out)")
    ap.add_argument("--out", type=str, default=None,
                    help="write the output document here instead of stdout")
    ap.add_argument("--json", action="store_true",
                    help="emit the shared CLI envelope "
                         "(tool/schema/mode/ok/findings/data) on stdout")
    ap.add_argument("--alpha", type=float, default=0.05,
                    help="rank-test significance level (default 0.05)")
    ap.add_argument("--min-rel", type=float, default=0.05,
                    help="minimum relative shift to flag when reps "
                         "support a rank test (default 0.05)")
    ap.add_argument("--scalar-min-rel", type=float, default=0.10,
                    help="minimum relative shift for scalar-only metrics "
                         "with no recorded spread (default 0.10)")
    return ap


def _emit(args, doc: dict, text_lines: Sequence[str]) -> None:
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        for line in text_lines:
            print(line)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        if args.collect:
            bundle = collect_bundle(args.collect)
            out_text = json.dumps(bundle, indent=2, sort_keys=True)
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    f.write(out_text + "\n")
            env = make_envelope(
                "iwae-prof", "collect", ok=True,
                data={"out": args.out,
                      "artifacts": sorted(bundle["artifacts"])})
            lines = [f"iwae-prof: collected {len(bundle['artifacts'])} "
                     f"artifact(s)"
                     + (f" -> {args.out}" if args.out else "")]
            if not args.out and not args.json:
                lines = [out_text]
            _emit(args, env, lines)
            return 0

        if len(args.diff) < 2:
            print("iwae-prof: --diff needs OLD and at least one NEW path",
                  file=sys.stderr)
            return 2
        old = _load_side(args.diff[:1])
        new = _load_side(args.diff[1:])
        if len(old) == 1 and len(new) == 1 and set(old) != set(new):
            # the plain two-artifact form (`--diff old.json new.json`):
            # one doc a side is an explicit pairing — filename stems need
            # not match (bundle-vs-tree diffs still match by stem)
            (odoc,), (nname,) = old.values(), new.keys()
            old = {nname: odoc}
        findings, stats = diff_bundles(
            old, new, alpha=args.alpha, min_rel=args.min_rel,
            scalar_min_rel=args.scalar_min_rel)
        ok = not findings
        env = make_envelope("iwae-prof", "diff", ok=ok,
                            findings=findings, data=stats)
        lines = []
        for f in findings:
            direction = "slower" if f["rel_change"] > 0 else "worse"
            p_txt = (f", p={f['p_value']:.4f}" if f["p_value"] is not None
                     else ", scalar")
            lines.append(
                f"REGRESSION {f['artifact']}:{f['key']} "
                f"{f['old_median']:.6g} -> {f['new_median']:.6g} "
                f"({f['rel_change']:+.1%} {direction}, "
                f"floor {f['noise_floor']:.1%}{p_txt})")
        n_cmp = sum(s.get("compared", 0)
                    for s in stats["per_artifact"].values())
        lines.append(
            f"iwae-prof: {len(findings)} regression(s) across "
            f"{stats['artifacts_compared']} artifact(s) "
            f"({n_cmp} directional metrics compared)")
        for name in stats["artifacts_only_new"]:
            lines.append(f"iwae-prof: note: {name} has no baseline entry")
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(json.dumps(env, indent=2) + "\n")
        _emit(args, env, lines)
        return 0 if ok else 1
    except (OSError, json.JSONDecodeError) as e:
        print(f"iwae-prof: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

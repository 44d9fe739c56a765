"""Replay reports: SLI summaries and the replay-vs-incident diff.

The port's own copy of ``tpuserve/replay/report.py``.

The replay harness emits the same SLI families production exports
(per-class TTFT/ITL/e2e, brownout level, shed/preempt/salvage
counters); this module folds raw samples into the flight recorder's
``sli_summary`` shape — the SAME percentile arithmetic as
``runtime/flight.py`` (sorted values, p50 at ``n//2``, p95 at
``int(n*0.95)``), so a replay percentile and a recorded-incident
percentile are directly comparable numbers, not two estimators — and
diffs a replay report against the incident bundle it came from.
"""

from __future__ import annotations

from typing import Optional

SLI_KINDS = ("ttft", "itl", "e2e")


def sli_summary(samples: dict) -> dict:
    """{(slo_class, kind): [seconds]} -> the flight-recorder summary
    shape {class: {kind: {n, p50, p95}}}."""
    out: dict = {}
    for (cls, kind), vals in sorted(samples.items()):
        vals = sorted(vals)
        if not vals:
            continue
        out.setdefault(cls, {})[kind] = {
            "n": len(vals),
            "p50": round(vals[len(vals) // 2], 6),
            "p95": round(vals[min(len(vals) - 1,
                                  int(len(vals) * 0.95))], 6),
        }
    return out


def _source_outcome_counts(workload) -> dict:
    counts: dict = {}
    for r in workload.requests:
        key = r.source_outcome or "unknown"
        counts[key] = counts.get(key, 0) + 1
    return counts


def diff_report(report: dict, workload, source_sli: Optional[dict] = None,
                ) -> dict:
    """Diff a replay report against the incident it replays.

    ``source_sli`` defaults to the SLI summary the extraction stashed in
    ``workload.meta["source_sli"]`` (the bundle's recorded client SLIs);
    pass a bundle's ``sli`` dict explicitly to diff against a different
    capture.  Ratios are replay/source — under virtual time they measure
    how faithfully ``step_time_s`` models the incident's real per-cycle
    cost, and per-CLASS ratio *spread* measures whether the policy
    dynamics (admission order, brownout, preemption) replayed honestly.
    """
    source_sli = source_sli if source_sli is not None \
        else workload.meta.get("source_sli", {})
    sli_diff: dict = {}
    for cls in sorted(set(source_sli) | set(report.get("sli", {}))):
        src_k = source_sli.get(cls, {})
        rep_k = report.get("sli", {}).get(cls, {})
        for kind in sorted(set(src_k) | set(rep_k)):
            s, r = src_k.get(kind), rep_k.get(kind)
            entry: dict = {"source": s, "replay": r}
            if s and r:
                for q in ("p50", "p95"):
                    if s.get(q):
                        entry[f"ratio_{q}"] = round(r[q] / s[q], 3)
            sli_diff.setdefault(cls, {})[kind] = entry
    src_outcomes = _source_outcome_counts(workload)
    rep_counters = dict(report.get("counters", {}))
    rep_outcomes: dict = {}
    for v in report.get("outcomes", {}).values():
        rep_outcomes[v] = rep_outcomes.get(v, 0) + 1
    return {
        "sli": sli_diff,
        "source_outcomes": src_outcomes,
        "replay_outcomes": rep_outcomes,
        "replay_counters": rep_counters,
        "source_engine": workload.meta.get("source_engine"),
        "replay_engine": report.get("engine"),
        "truncated_source": bool(workload.meta.get("truncated")),
        "source_wall_span_s": workload.meta.get("source_wall_span_s"),
        "replay": {k: report.get(k) for k in
                   ("virtual_s", "wall_s", "speedup", "step_time_s",
                    "aborted", "token_digest", "sli_digest")},
    }


def render_diff(diff: dict) -> str:
    """Human-readable diff."""
    lines = ["replay vs source incident", "=" * 25]
    rep = diff.get("replay", {})
    lines.append(
        f"virtual {rep.get('virtual_s')}s in wall {rep.get('wall_s')}s "
        f"(speedup {rep.get('speedup')}x, step_time "
        f"{rep.get('step_time_s')}s"
        + (", ABORTED" if rep.get("aborted") else "") + ")")
    if diff.get("truncated_source"):
        lines.append("WARNING: source bundle was truncated/torn — the "
                     "workload filled gaps with defaults")
    lines.append("")
    lines.append(f"{'class/kind':<20}{'src p50':>10}{'rep p50':>10}"
                 f"{'ratio':>8}{'src p95':>10}{'rep p95':>10}{'ratio':>8}")
    for cls, kinds in sorted(diff.get("sli", {}).items()):
        for kind, e in sorted(kinds.items()):
            s, r = e.get("source") or {}, e.get("replay") or {}
            lines.append(
                f"{cls + '/' + kind:<20}"
                f"{s.get('p50', '-'):>10}{r.get('p50', '-'):>10}"
                f"{e.get('ratio_p50', '-'):>8}"
                f"{s.get('p95', '-'):>10}{r.get('p95', '-'):>10}"
                f"{e.get('ratio_p95', '-'):>8}")
    lines.append("")
    lines.append(f"source outcomes: {diff.get('source_outcomes')}")
    lines.append(f"replay outcomes: {diff.get('replay_outcomes')}")
    c = diff.get("replay_counters", {})
    lines.append(
        "replay counters: "
        + ", ".join(f"{k}={c[k]}" for k in
                    ("completed", "shed", "rejected", "deadline_aborted",
                     "salvage_rounds", "preemptions",
                     "max_brownout_level") if k in c))
    return "\n".join(lines)

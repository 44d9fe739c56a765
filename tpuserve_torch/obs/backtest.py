"""Alert backtesting: run the burn-rate engine over a replayed incident.

The port's own copy of ``tpuserve/obs/backtest.py`` (its imports are the port's).

Every captured flight bundle is an alert-tuning scenario: the replay
harness re-executes the incident against the real engine under
``VirtualClock``, and this module rides the harness's observer hook to
feed the SAME :class:`~tpuserve_torch.obs.burnrate.BurnRateEvaluator` that
runs in production — so "which alerts would have fired, and when" is an
answer computed by the production code path, not a simulation of it.

Determinism contract (tests/test_torch_replay.py): same replay bundle +
same objectives file => byte-identical alert firing sequence.  The
replay is deterministic (same seed => same tokens/SLIs), the evaluator
is a pure function of the observation stream and the virtual clock, and
the report carries sha256 digests of both sides so the pin is checkable
from the artifact alone.

The practical loop: capture a storm (post-mortem or
``/debug/engine/dump``), then ``backtest(workload_from_bundle(bundle),
objectives)`` — tighten a threshold, rerun, diff the
firing sequence.  Paging thresholds get tuned against recorded
incidents instead of production regret.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence

from tpuserve_torch.obs.burnrate import (BurnRateEvaluator, BurnWindow,
                                         DEFAULT_WINDOWS, EVAL_INTERVAL_S)
from tpuserve_torch.obs.objectives import (DEFAULT_OBJECTIVES, SLOObjective,
                                           objectives_digest)

BACKTEST_SCHEMA_VERSION = 1

#: outcomes the availability objective counts as served
GOOD_OUTCOMES = ("stop", "length")


class _BacktestObserver:
    """The replay harness's observer: builds the evaluator once the
    harness hands over its VirtualClock, then mirrors every SLI sample
    and terminal outcome into it, evaluating at each cycle end."""

    def __init__(self, objectives, windows, min_events: int):
        self._objectives = objectives
        self._windows = windows
        self._min_events = min_events
        self._clock = None
        self._last_eval = None
        self.evaluator: Optional[BurnRateEvaluator] = None

    def bind_clock(self, clock) -> None:
        self._clock = clock
        self.evaluator = BurnRateEvaluator(
            self._objectives, self._windows, clock=clock,
            min_events=self._min_events)

    def on_sli(self, slo_class: str, kind: str, value: float) -> None:
        self.evaluator.observe(slo_class, kind, value)

    def on_outcome(self, slo_class: str, outcome: str) -> None:
        self.evaluator.observe_outcome(slo_class,
                                       outcome in GOOD_OUTCOMES)

    def on_tick(self) -> None:
        # same evaluation cadence as the production runner's throttle
        # (virtual seconds here) — a sub-interval excursion that
        # production would never see must not fire in the backtest
        now = self._clock.monotonic()
        if self._last_eval is not None \
                and now - self._last_eval < EVAL_INTERVAL_S:
            return
        self._last_eval = now
        self.evaluator.evaluate()


def backtest(workload, objectives: Sequence[SLOObjective] = (),
             windows: Sequence[BurnWindow] = (),
             replay_opts=None, min_events: int = 10) -> dict:
    """Replay ``workload`` and report the alert firing sequence the
    given objectives would have produced.  ``replay_opts`` are normal
    :class:`~tpuserve_torch.replay.harness.ReplayOptions` (engine sizing,
    step time); the observer slot is taken by the backtester."""
    from tpuserve_torch.replay.harness import ReplayOptions, replay
    objectives = tuple(objectives) or DEFAULT_OBJECTIVES
    windows = tuple(windows) or DEFAULT_WINDOWS
    observer = _BacktestObserver(objectives, windows, min_events)
    # never mutate the caller's options: a reused ReplayOptions must
    # not keep feeding a dead backtest observer on its next replay
    opts = dataclasses.replace(
        replay_opts or ReplayOptions(include_token_streams=False),
        observer=observer)
    report = replay(workload, opts)
    ev = observer.evaluator
    # final evaluation at the replay's end time: a storm that never
    # cooled keeps its alerts firing into the report's "unresolved"
    ev.evaluate()
    transitions = ev.transitions
    firing_digest = hashlib.sha256(json.dumps(
        transitions, sort_keys=True).encode()).hexdigest()
    fired = sorted({f"{t['objective']}/{t['window']}"
                    for t in transitions if t["state"] == "firing"})
    return {
        "schema_version": BACKTEST_SCHEMA_VERSION,
        "objectives": [o.as_dict() for o in objectives],
        "objectives_digest": objectives_digest(objectives),
        "windows": [dataclasses.asdict(w) for w in windows],
        "min_events": min_events,
        "transitions": transitions,
        "firing_digest": firing_digest,
        "alerts_fired": fired,
        "unresolved": ev.firing(),
        "workload": workload.summary(),
        "replay": {k: report.get(k) for k in
                   ("virtual_s", "wall_s", "speedup", "step_time_s",
                    "aborted", "token_digest", "sli_digest")},
        "counters": report.get("counters", {}),
    }


def render_backtest(result: dict) -> str:
    """Human-readable firing sequence."""
    lines = ["alert backtest", "=" * 14,
             f"objectives digest {result['objectives_digest'][:16]}… "
             f"firing digest {result['firing_digest'][:16]}…",
             f"replayed {result['replay'].get('virtual_s')}s virtual in "
             f"{result['replay'].get('wall_s')}s wall", ""]
    if not result["transitions"]:
        lines.append("no alerts would have fired")
    else:
        lines.append(f"{'t(virtual s)':>12}  {'state':<9} "
                     f"{'objective/window':<34} burn long/short")
        for tr in result["transitions"]:
            lines.append(
                f"{tr['t']:>12.3f}  {tr['state'].upper():<9} "
                f"{tr['objective'] + '/' + tr['window']:<34} "
                f"{tr['burn_long']:g}/{tr['burn_short']:g}")
        lines.append("")
        lines.append(f"fired: {result['alerts_fired']}")
        if result["unresolved"]:
            lines.append(f"still firing at replay end: "
                         f"{result['unresolved']}")
    return "\n".join(lines)

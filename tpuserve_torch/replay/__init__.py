"""Trace-driven replay harness: the port's own copy of ``tpuserve/replay``,
its engines the port's on an explicit device.

Flight-recorder dumps, post-mortem bundles and bench traces convert
into portable, versioned workload files (``workload.py`` /
``extract.py``) that replay deterministically against the real engine
in virtual time (``harness.py``) and report the same SLI families
production exports, diffed against the source incident
(``report.py``).
"""

from tpuserve_torch.replay.extract import (load_bundle, merge_engine_bundles,
                                           workload_from_bundle)
from tpuserve_torch.replay.harness import (ReplayOptions, build_replay_engine,
                                           replay)
from tpuserve_torch.replay.report import diff_report, render_diff, sli_summary
from tpuserve_torch.replay.workload import (WORKLOAD_SCHEMA_VERSION, Workload,
                                            WorkloadRequest)

__all__ = [
    "WORKLOAD_SCHEMA_VERSION", "Workload", "WorkloadRequest",
    "load_bundle", "merge_engine_bundles", "workload_from_bundle",
    "ReplayOptions", "build_replay_engine", "replay",
    "diff_report", "render_diff", "sli_summary",
]

"""SLO class names and ranks — the part of ``tpuserve/runtime/slo.py`` that
the scheduler reads.

The port's engine runs classless FIFO (``Scheduler.slo`` stays None), so
the brownout ladder and load estimator are not ported; the scheduler only
needs ``class_rank`` and the ``BATCH`` rank for its queue ordering.
"""

from __future__ import annotations

SLO_CLASSES = ("interactive", "standard", "batch")
INTERACTIVE, STANDARD, BATCH = range(3)
_RANK = {name: i for i, name in enumerate(SLO_CLASSES)}


def class_rank(name: str) -> int:
    """Rank of an SLO class name (0 = strictest).  Raises ``ValueError``
    on junk so intake surfaces an error, not a silent default."""
    try:
        return _RANK[name]
    except KeyError:
        raise ValueError(
            f"unknown slo_class {name!r}; one of {'/'.join(SLO_CLASSES)}"
        ) from None

"""SLO evaluation: declared objectives, burn-rate evaluation, synthetic
canaries and alert backtesting, the port's own copy of ``tpuserve/obs``.

- ``objectives.py``: per-SLO-class targets, validated against the port's
  metric families and the pinned histogram bucket edges;
- ``burnrate.py``: multi-window multi-burn-rate evaluation in process (fed
  by the server's runner under the engine clock) and compiled to PromQL;
- ``canary.py``: a black-box prober sending tagged tiny requests per SLO
  class through the real serving path;
- ``backtest.py``: the burn-rate engine over a replay of a flight bundle
  under ``VirtualClock`` (``replay/``): which alerts would have fired, and
  when.
"""

from tpuserve_torch.obs.backtest import backtest  # noqa: F401

from tpuserve_torch.obs.burnrate import (BurnRateEvaluator, BurnWindow,  # noqa: F401
                                         DEFAULT_WINDOWS, promql_burn_expr)
from tpuserve_torch.obs.canary import CanaryConfig, CanaryProber  # noqa: F401
from tpuserve_torch.obs.objectives import (DEFAULT_OBJECTIVES,  # noqa: F401
                                           SLOObjective, load_objectives,
                                           objectives_digest, validate_objectives)

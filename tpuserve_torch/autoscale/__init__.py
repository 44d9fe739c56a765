"""SLI-driven autoscaler: the port's own copy of ``tpuserve/autoscale``.

The engine narrates its own load (flight-recorder SLI families,
``tpuserve_brownout_level``, per-class queue-delay EWMAs); this package
closes the loop: ``policy.py`` turns those signals into hysteretic
scale decisions, ``reconciler.py`` applies them to a replica pool
(kubectl in production, publishing a backends file the gateway polls),
and ``pool.py`` replays recorded brownout storms against a *simulated*
pool of real engines under one shared ``VirtualClock`` — so the whole
control plane is tunable and tier-1-testable on CPU, no Kubernetes.
CLI: ``python -m tpuserve_torch.autoscale`` (the scaler Deployment's
entrypoint, provision/manifests.py).
"""

from tpuserve_torch.autoscale.policy import (ACTIONS, AutoscalePolicy, Decision,
                                             PolicyConfig, PoolSignals,
                                             ReplicaSignals, decisions_digest)
from tpuserve_torch.autoscale.pool import (PoolReplayOptions, make_storm_workload,
                                           pool_replay)
from tpuserve_torch.autoscale.reconciler import (KubePool, Reconciler,
                                                 write_backends_file)
from tpuserve_torch.autoscale.signals import (scrape_replica, signals_from_debug,
                                              signals_from_metrics)

__all__ = [
    "ACTIONS", "AutoscalePolicy", "Decision", "PolicyConfig",
    "PoolSignals", "ReplicaSignals", "decisions_digest",
    "PoolReplayOptions", "make_storm_workload", "pool_replay",
    "KubePool", "Reconciler", "write_backends_file",
    "scrape_replica", "signals_from_debug", "signals_from_metrics",
]

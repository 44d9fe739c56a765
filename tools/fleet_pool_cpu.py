#!/usr/bin/env python3
"""chip_smoke.py's fleet storm through the simulated pool, on the CPU.

    python3 tools/fleet_pool_cpu.py

Runs ``pool_replay`` of the ``fleet`` phase's storm (``FLEET_STORM``,
``FLEET_POOL``, ``FLEET_POLICY``) on port engines of ``tiny-qwen3`` on the
CPU and prints the decisions, their digest, the first scale-out, L3 entry
and shed, and the counters.  The policy reads only scheduling, which
greedy, length-bound requests make independent of the weights, so the
card's run of the phase takes the same decisions; its L3 and shed times
may sit a cycle apart (the card pipelines its decode windows, the CPU
does not).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tpuserve_torch.autoscale import (PolicyConfig, PoolReplayOptions,  # noqa: E402
                                      make_storm_workload, pool_replay)


def main() -> int:
    rep = pool_replay(make_storm_workload(**chip_smoke.FLEET_STORM),
                      PoolReplayOptions(model="tiny-qwen3", device="cpu",
                                        **chip_smoke.FLEET_POOL),
                      PolicyConfig(**chip_smoke.FLEET_POLICY))
    print(json.dumps({k: rep[k] for k in (
        "decisions", "decision_digest", "first_scale_out_t", "first_l3_t", "first_shed_t",
        "replicas_peak", "counters")}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

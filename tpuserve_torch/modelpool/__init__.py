"""Model pool: weight tiering and hot-swap so one replica serves a
catalog, the port of ``tpuserve/modelpool``.

See :mod:`tpuserve_torch.modelpool.pool` for the swap controller and
:mod:`tpuserve_torch.modelpool.tiers` for the card -> pinned host ->
spill-directory weight store.  ``TPUSERVE_MODELPOOL=0`` (or no catalog)
constructs no pool at all."""

from tpuserve_torch.modelpool.pool import (ModelPool, ModelPoolConfig, parse_catalog,
                                           pool_enabled)
from tpuserve_torch.modelpool.tiers import WeightTiers

__all__ = ["ModelPool", "ModelPoolConfig", "WeightTiers", "parse_catalog", "pool_enabled"]

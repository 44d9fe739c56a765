"""Multi-device serving: the port of ``tpuserve/parallel/`` (ROADMAP.md
A10, first part).  ``mesh`` (the rank grid), ``sharding`` (a rank's slice
of the weights), ``multihost`` (the lockstep ranks), ``disagg`` (in-process
prefill/decode disaggregation) and ``disagg_net`` (across pods).  Pipeline,
ring attention and training wait for the next part."""

from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
from tpuserve_torch.parallel.sharding import rank_config, shard_params

__all__ = ["MeshConfig", "make_mesh", "multihost_initialize", "rank_config",
           "shard_params"]

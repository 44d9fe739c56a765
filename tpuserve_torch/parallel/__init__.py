"""Multi-device serving and training: the port of ``tpuserve/parallel/``
(ROADMAP.md A10).  ``mesh`` (the rank grid), ``sharding`` (a rank's slice
of the weights), ``multihost`` (the lockstep ranks), ``pipeline`` (pipeline
stages), ``ring_attention`` (ring and Ulysses context parallelism),
``train`` (the fine-tuning step), ``disagg`` (in-process prefill/decode
disaggregation) and ``disagg_net`` (across pods)."""

from tpuserve_torch.parallel.mesh import MeshConfig, make_mesh, multihost_initialize
from tpuserve_torch.parallel.sharding import rank_config, shard_params

__all__ = ["MeshConfig", "make_mesh", "multihost_initialize", "rank_config",
           "shard_params"]

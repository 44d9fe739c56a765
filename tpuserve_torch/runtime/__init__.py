"""The serving runtime: engine, scheduler, block manager and KV cache."""

from tpuserve_torch.runtime.engine import Engine, EngineConfig, EngineStats
from tpuserve_torch.runtime.kv_cache import CacheConfig
from tpuserve_torch.runtime.request import FinishReason, RequestOutput, SamplingParams
from tpuserve_torch.runtime.scheduler import SchedulerConfig

__all__ = ["CacheConfig", "Engine", "EngineConfig", "EngineStats",
           "FinishReason", "RequestOutput", "SamplingParams", "SchedulerConfig"]

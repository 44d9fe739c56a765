"""The port's HTTP server: ``python -m tpuserve_torch.server``."""

from tpuserve_torch.server.metrics import ServerMetrics
from tpuserve_torch.server.openai_api import OpenAIServer, ServerConfig
from tpuserve_torch.server.runner import AsyncEngineRunner

__all__ = ["AsyncEngineRunner", "OpenAIServer", "ServerConfig", "ServerMetrics"]

"""cxxnet_tpu_torch.serve — dynamic-batching inference serving of a live
model: :mod:`.engine` (ServingEngine), :mod:`.server` (HTTP /predict,
/healthz, /metrics) and :mod:`.stats` (ServeStats), the forward path of
``cxxnet_tpu.serve``. CLI: ``task = serve`` with ``model_in``."""

from .engine import (DrainError, QueueFullError, Request,
                     RequestExpired, ServingEngine)
from .stats import ServeStats

__all__ = ["QueueFullError", "Request", "RequestExpired", "DrainError",
           "ServingEngine", "ServeStats"]

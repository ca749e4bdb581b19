from .config import (
    TrackerConfig,
    ForensicConfig,
    DetectorConfig,
    ServerConfig,
    TrainConfig,
)
from .device import resolve_device

__all__ = [
    "TrackerConfig",
    "ForensicConfig",
    "DetectorConfig",
    "ServerConfig",
    "TrainConfig",
    "resolve_device",
]

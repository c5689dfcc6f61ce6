from .observability import (DeviceStatsPoller, StageTimer,
                            device_memory_stats, profile_trace)

__all__ = ["DeviceStatsPoller", "StageTimer", "device_memory_stats",
           "profile_trace"]

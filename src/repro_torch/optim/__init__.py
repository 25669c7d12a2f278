from .adamw import (AdamWConfig, AdamWState, clip_by_global_norm,
                    global_norm, init, schedule, update)

__all__ = ["AdamWConfig", "AdamWState", "clip_by_global_norm", "global_norm",
           "init", "schedule", "update"]

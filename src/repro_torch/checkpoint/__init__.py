"""Fault-tolerance substrate: async checkpointing (the reference's
on-disk format) + step watchdog."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.watchdog import StepWatchdog

__all__ = ["CheckpointManager", "StepWatchdog"]

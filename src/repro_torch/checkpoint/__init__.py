"""Checkpoints of the port: the training store and the streaming sweeps'
chunk store, in the reference's file format."""

from repro_torch.checkpoint.store import CheckpointStore, SweepCheckpoint

__all__ = ["CheckpointStore", "SweepCheckpoint"]

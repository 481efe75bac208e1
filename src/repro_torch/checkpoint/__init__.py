"""Checkpoints as datasets in the object store (``ckpt``)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step, reconcile_partial_save, restore, save, CheckpointManager)

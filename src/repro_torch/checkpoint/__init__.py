"""Checkpoints in the reference's format (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    latest_step,
    load_metadata,
    restore,
    save,
)

"""Checkpoint substrate: a tree of arrays <-> .npz + versioned JSON manifest,
with rotation, the ``LATEST`` pointer and caller metadata (``extra``), in the
reference's on-disk format."""
from repro_torch.checkpoint.io import (latest_step, point_latest,  # noqa: F401
                                       read_latest, read_manifest, restore, save)

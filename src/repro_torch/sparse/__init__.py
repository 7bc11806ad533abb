"""Sparse features for the port: padded-ELL planes, per-node partitions and
the touched-block schedule helpers (``formats``)."""
from repro_torch.sparse.formats import (  # noqa: F401
    DEFAULT_BUCKET_BLK_D, ELL, EllPartitions, block_map, minibatch_block_bound,
    partition_rows, row_block_counts,
)

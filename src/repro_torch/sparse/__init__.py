"""Sparse features for the port: padded-ELL planes, per-node partitions,
the touched-block schedule helpers and the padding of serving queries into
bucket shapes (``formats``)."""
from repro_torch.sparse.formats import (  # noqa: F401
    DEFAULT_BUCKET_BLK_D, ELL, EllPartitions, block_map, minibatch_block_bound,
    pad_query_planes, partition_rows, row_block_counts,
)

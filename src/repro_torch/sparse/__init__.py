"""Sparse features for the port: CSR and padded-ELL containers, per-node
partitions, the touched-block schedule helpers and the padding of serving
queries into bucket shapes (``formats``). Streaming LibSVM ingest is
``repro_torch.data.libsvm``."""
from repro_torch.sparse.formats import (  # noqa: F401
    CSR, ELL, BlockBuckets, DEFAULT_BUCKET_BLK_D, EllPartitions,
    block_map, bucket_by_block, frequency_remap, minibatch_block_bound,
    pad_query_planes, partition_rows, row_block_counts,
)

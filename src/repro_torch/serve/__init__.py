"""Serving for the port: snapshot → versioned checkpoint → score, live.

``snapshot`` decodes the training loop's anytime ring and exports a model
state as a checkpoint (f32 or int8 + scale) in the reference's format;
``publisher`` trains in a background thread and publishes a checkpoint per
stream segment (monotone versions, the ``LATEST`` pointer, crash-resume);
``batcher`` is the serving control plane's queue: ``MicroBatcher`` buckets
ragged sparse queries into a small fixed set of pad shapes, with bounded
admission (``max_pending`` and the reject/shed/block policies), deadlines
and typed ``QueryRejected`` / ``Shed`` / ``DeadlineExceeded`` outcomes;
``engine`` is ``SvmServer``, scoring dense batches on the ``dense_scores``
kernel and padded-ELL batches on ``ell_scores_prefetch``, with ``watch`` /
``maybe_reload`` hot-swapping the weight plane between drains, and
``make_mesh_scorer`` splitting a batch over a mesh of processes; ``overload``
is the hysteretic ``DegradeLadder`` stepping a server and its batcher to
the int8 plane and the cheapest bucket under sustained pressure.
"""
from repro_torch.serve.batcher import (ADMISSION_POLICIES, Bucket,  # noqa: F401
                                       DeadlineExceeded, MicroBatcher, QueryRejected,
                                       Shed, bucket_ladder, calibrate_buckets)
from repro_torch.serve.engine import SvmServer, make_mesh_scorer  # noqa: F401
from repro_torch.serve.overload import DegradeLadder  # noqa: F401
from repro_torch.serve.publisher import TrainPublisher  # noqa: F401
from repro_torch.serve.snapshot import (SERVE_FORMAT_VERSION, SERVE_KIND,  # noqa: F401
                                        Snapshot, dequantize_int8, from_checkpoint, latest,
                                        latest_train_state, quantize_int8, snapshots_from,
                                        to_checkpoint, train_state_from_checkpoint)

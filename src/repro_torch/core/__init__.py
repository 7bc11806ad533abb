"""Core of the port: primal SVM objective, gossip topologies, Push-Sum,
fault injection and the GADGET trainer, as PyTorch functions on tensors.

* topology      — gossip graphs and stochastic mixing matrices
* push_sum      — Push-Sum: the matrix-form simulator and the mesh rounds
* mesh          — a named mesh of processes over torch.distributed
* svm_objective — primal SVM math shared by the trainer and the kernels
* pegasos       — the centralised Pegasos baseline
* cutting_plane — the cutting-plane and SVM-SGD baselines
* gadget        — the GADGET trainer, its stream, host loop and mesh step
* multiclass    — one-vs-rest GADGET over shared gossip
* consensus     — gossip against all-reduce for any model's parameters
* faults        — fault injection (FaultPlan) for gossip
* resilience    — host-side faulty Push-Sum simulator over the same plan
"""
from repro_torch.core.topology import (  # noqa: F401
    TOPOLOGIES,
    build_matrix,
    is_doubly_stochastic,
    mixing_time_bound,
)
from repro_torch.core.push_sum import (  # noqa: F401
    GossipRound,
    PushSumSim,
    PushSumState,
    exponential_schedule,
    push_sum_mesh,
    push_sum_round,
)
from repro_torch.core.mesh import Mesh  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    FaultPlan,
    apply_faults,
    faulty_rounds,
    validate_plan,
)
from repro_torch.core.resilience import FaultySim  # noqa: F401
from repro_torch.core.gadget import (  # noqa: F401
    GadgetConfig,
    GadgetResult,
    TrainState,
    gadget_train,
    gadget_train_reference,
    gadget_train_stream,
    make_gadget_mesh_step,
    reset_transfer_stats,
    transfer_stats,
)
from repro_torch.core.pegasos import PegasosResult, pegasos_train  # noqa: F401
from repro_torch.core.cutting_plane import cutting_plane_svm, svm_sgd  # noqa: F401
from repro_torch.core.multiclass import (  # noqa: F401
    MulticlassResult,
    gadget_train_multiclass,
    predict_multiclass,
)
from repro_torch.core.consensus import (  # noqa: F401
    ConsensusConfig,
    allreduce_grads,
    gossip_mix,
    gossip_mix_stacked,
    mix_params,
)

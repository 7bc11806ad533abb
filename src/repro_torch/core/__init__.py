"""Core of the port: primal SVM objective, gossip topologies, Push-Sum,
fault injection and the GADGET trainer, as PyTorch functions on tensors.

* topology      — gossip graphs and stochastic mixing matrices
* push_sum      — Push-Sum in matrix form (mix, collapse, PushSumState)
* svm_objective — primal SVM math shared by the trainer and the kernels
* gadget        — the distributed GADGET SVM trainer and its stream
* faults        — fault injection (FaultPlan) for gossip
* resilience    — host-side faulty Push-Sum simulator over the same plan
"""
from repro_torch.core.topology import (  # noqa: F401
    TOPOLOGIES,
    build_matrix,
    is_doubly_stochastic,
    mixing_time_bound,
)
from repro_torch.core.push_sum import PushSumState  # noqa: F401
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
    gadget_train_stream,
)

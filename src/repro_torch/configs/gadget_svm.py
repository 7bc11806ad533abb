"""The paper's own model: a linear SVM trained with GADGET gossip consensus.

A copy of ``repro.configs.gadget_svm`` over the port's ``GadgetConfig`` (the
port imports nothing of ``repro``). Not one of the transformer
architectures: this config carries the paper's experiment parameters
(Tables 2 and 3: k = 10 nodes, ε = 1e-3, λ per dataset).
"""
from dataclasses import dataclass

from repro_torch.core.gadget import GadgetConfig

__all__ = ["PaperRun", "PAPER_RUNS"]


@dataclass(frozen=True)
class PaperRun:
    """One dataset's run: its name, the number of nodes and the config."""

    dataset: str
    n_nodes: int
    gadget: GadgetConfig


def _run(dataset: str, lam: float, max_iters: int = 4000) -> PaperRun:
    return PaperRun(
        dataset=dataset,
        n_nodes=10,  # k = 10 in the paper's experiments
        gadget=GadgetConfig(
            lam=lam,
            batch_size=1,           # paper: one instance per iteration
            gossip_rounds=4,        # ~log2(10) + slack: gamma ~ 1e-2 per step
            topology="random",      # the paper's uniform random neighbor
            epsilon=1e-3,           # paper's convergence epsilon
            check_every=200,
            max_iters=max_iters,
        ),
    )


PAPER_RUNS = {
    "adult":   _run("adult",   3.07e-5),
    "ccat":    _run("ccat",    1e-4),
    "mnist":   _run("mnist",   1.67e-5),
    "reuters": _run("reuters", 1.29e-4),
    "usps":    _run("usps",    1.36e-4),
    "webspam": _run("webspam", 1e-5),
}

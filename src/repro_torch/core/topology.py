"""Gossip graph topologies and their mixing matrices.

The numpy builders are a copy of ``repro.core.topology``'s (the port imports
nothing of ``repro``): protocol metadata, tiny (n ≤ 512), built on the host
and uploaded once as a stacked cycle. Semantics: B[i, j] is the share of
node i's mass pushed to node j, and one Push-Sum round applies x' = Bᵀx.
:func:`random_neighbor_matrix_device` builds the paper's random
one-neighbour protocol on the device from given raw draws (the trainer's
keyed ones); it has the reference's distribution but not its
``jax.random`` stream.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ring_matrix",
    "complete_matrix",
    "torus_matrix",
    "random_neighbor_matrix",
    "random_neighbor_matrix_device",
    "metropolis_matrix",
    "one_peer_exponential_matrix",
    "exponential_partner",
    "exponential_cycle_length",
    "is_doubly_stochastic",
    "mixing_time_bound",
    "build_matrix",
    "matrix_period",
    "build_matrix_stack",
    "product_period",
    "build_product_stack",
    "TOPOLOGIES",
    "DETERMINISTIC_TOPOLOGIES",
]


def _check_n(n: int) -> None:
    if n < 1:
        raise ValueError(f"need at least one node, got n={n}")


def ring_matrix(n: int, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    """Symmetric ring: each node averages with its two ring neighbors."""
    _check_n(n)
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.full((2, 2), 0.5)
    side = (1.0 - self_weight) / 2.0
    B = np.zeros((n, n))
    idx = np.arange(n)
    B[idx, idx] = self_weight
    B[idx, (idx + 1) % n] = side
    B[idx, (idx - 1) % n] = side
    return B


def complete_matrix(n: int) -> np.ndarray:
    """Uniform gossip on the complete graph: B = 11^T / n (one-shot mixing)."""
    _check_n(n)
    return np.full((n, n), 1.0 / n)


def torus_matrix(n: int, self_weight: float = 0.2) -> np.ndarray:
    """2-D torus (grid with wraparound): each node averages with its four
    lattice neighbors. The grid is r × c with r the largest divisor of n not
    exceeding sqrt(n) — degenerate rows/columns fold duplicate neighbors back
    onto the same entry, so the matrix stays symmetric doubly stochastic for
    every n (an r=1 torus is just the ring).
    """
    _check_n(n)
    if n == 1:
        return np.ones((1, 1))
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    c = n // r
    share = (1.0 - self_weight) / 4.0
    B = np.zeros((n, n))
    idx = np.arange(n)
    row, col = np.divmod(idx, c)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        j = ((row + dr) % r) * c + (col + dc) % c
        np.add.at(B, (idx, j), share)
    B[idx, idx] += self_weight
    return B


def random_neighbor_matrix(n: int, rng: np.random.Generator, self_share: float = 0.5) -> np.ndarray:
    """The paper's protocol: each node keeps ``self_share`` of its mass and
    pushes the rest to one uniformly-random other node.

    Column-stochastic (mass conserving) but NOT row-stochastic for a single
    draw — which is exactly why Push-Sum carries the weight scalar w_{t,i}.
    In expectation the chain is doubly stochastic.
    """
    _check_n(n)
    if n == 1:
        return np.ones((1, 1))
    B = np.zeros((n, n))
    targets = rng.integers(0, n - 1, size=n)
    targets = targets + (targets >= np.arange(n))  # uniform over others
    B[np.arange(n), np.arange(n)] = self_share
    B[np.arange(n), targets] += 1.0 - self_share
    # Push-Sum semantics: B[i, j] = share of node i's mass sent to node j,
    # mixing update is x_{t+1} = B^T x_t. Columns of B^T sum to 1.
    return B


def metropolis_matrix(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights for an arbitrary undirected graph.

    B[i, j] = 1 / (1 + max(deg_i, deg_j)) for edges, diagonal gets the rest.
    Always symmetric doubly stochastic — the textbook choice when node degrees
    are heterogeneous.
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError("adjacency must be square")
    deg = adj.sum(axis=1)
    B = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                B[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        B[i, i] = 1.0 - B[i].sum()
    return B


def exponential_cycle_length(n: int) -> int:
    """k = ceil(log2 n): hops cycle through 1, 2, ..., 2^(k-1). The single
    source of truth for the one-peer exponential schedule length — both the
    per-round partner map and the stacked-matrix period derive from it."""
    return max(1, int(np.ceil(np.log2(n)))) if n > 1 else 1


def exponential_partner(n: int, t: int) -> np.ndarray:
    """Send-partner of every node at round t of the one-peer exponential graph.

    partner(i, t) = (i + 2^(t mod ceil(log2 n))) mod n.  For power-of-two n the
    sequence of rounds 0..log2(n)-1 realizes a hypercube all-to-all, i.e. exact
    averaging after log2(n) rounds.
    """
    _check_n(n)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    hop = 1 << (t % exponential_cycle_length(n))
    return (np.arange(n) + hop) % n


def one_peer_exponential_matrix(n: int, t: int, self_share: float = 0.5) -> np.ndarray:
    """Mixing matrix of round t of the deterministic one-peer exponential graph."""
    _check_n(n)
    if n == 1:
        return np.ones((1, 1))
    B = np.zeros((n, n))
    partners = exponential_partner(n, t)
    B[np.arange(n), np.arange(n)] = self_share
    B[np.arange(n), partners] += 1.0 - self_share
    return B


def is_doubly_stochastic(B: np.ndarray, atol: float = 1e-9) -> bool:
    """Nonnegative with unit row and column sums, to ``atol``."""
    B = np.asarray(B)
    return bool(
        np.all(B >= -atol)
        and np.allclose(B.sum(axis=0), 1.0, atol=atol)
        and np.allclose(B.sum(axis=1), 1.0, atol=atol)
    )


def mixing_time_bound(B: np.ndarray) -> float:
    """tau_mix estimate: 1 / log(1/|lambda_2|) from the second-largest singular
    value of the mixing matrix (= spectral gap bound on Push-Sum error decay)."""
    s = np.linalg.svd(np.asarray(B, dtype=np.float64), compute_uv=False)
    lam2 = s[1] if len(s) > 1 else 0.0
    if lam2 >= 1.0 - 1e-12:
        return float("inf")
    if lam2 <= 0.0:
        return 1.0
    return float(1.0 / np.log(1.0 / lam2))


TOPOLOGIES = ("ring", "complete", "torus", "random", "exponential")

#: topologies whose round-t matrix is a deterministic function of (n, t) — these
#: can be precomputed as a stacked (period, n, n) array and kept device-resident.
DETERMINISTIC_TOPOLOGIES = ("ring", "complete", "torus", "exponential")


def build_matrix(topology: str, n: int, t: int = 0, rng: np.random.Generator | None = None) -> np.ndarray:
    """Round-t mixing matrix for a named topology (simulator path)."""
    if topology == "ring":
        return ring_matrix(n)
    if topology == "complete":
        return complete_matrix(n)
    if topology == "torus":
        return torus_matrix(n)
    if topology == "random":
        rng = rng if rng is not None else np.random.default_rng(t)
        return random_neighbor_matrix(n, rng)
    if topology == "exponential":
        return one_peer_exponential_matrix(n, t)
    raise ValueError(f"unknown topology {topology!r}; expected one of {TOPOLOGIES}")


def matrix_period(topology: str, n: int) -> int:
    """Length of the round-t matrix cycle for a deterministic topology.

    ``exponential`` cycles through hops 1, 2, ..., 2^(k-1) with k = ceil(log2 n);
    the static graphs (ring, clique, torus) have period 1. ``random`` has no
    period — its matrices are drawn fresh each round (on device, see
    :func:`random_neighbor_matrix_device`).
    """
    if topology not in DETERMINISTIC_TOPOLOGIES:
        raise ValueError(f"{topology!r} has no deterministic period")
    return exponential_cycle_length(n) if topology == "exponential" else 1


def build_matrix_stack(topology: str, n: int) -> np.ndarray:
    """Stacked (period, n, n) mixing matrices covering one full cycle of a
    deterministic topology. Upload once, index with ``t % period`` on device —
    no per-round host builds remain in the training loop.
    """
    T = matrix_period(topology, n)
    return np.stack([build_matrix(topology, n, t=t) for t in range(T)]).astype(np.float32)


def product_period(topology: str, n: int, rounds_per_iter: int) -> int:
    """Length of the *per-iteration* collapsed-product cycle.

    Iteration t (1-based) consumes rounds ``(t-1)*R .. (t-1)*R + R-1`` of the
    round-matrix cycle (period T), so its product depends only on the start
    offset ``s_t = ((t-1)*R) mod T`` — which cycles with period T / gcd(T, R).
    For the static graphs (T=1) every iteration shares one product; for the
    exponential graph the cycle is at most T entries, i.e. the uploaded stack
    shrinks by R× relative to storing the R matrices of each iteration.
    """
    if rounds_per_iter < 1:
        raise ValueError(f"need rounds_per_iter >= 1, got {rounds_per_iter}")
    T = matrix_period(topology, n)
    return T // np.gcd(T, rounds_per_iter)


def build_product_stack(topology: str, n: int, rounds_per_iter: int) -> np.ndarray:
    """Stacked (product_period, n, n) collapsed per-iteration mixing products.

    ``mix_rounds`` is linear, so the R sequential Push-Sum rounds of one GADGET
    iteration fold exactly into a single matrix: applying rounds B_1..B_R as
    ``x' = B_R^T … B_1^T x`` equals ``x' = P x`` with ``P = (B_1 ⋯ B_R)^T``.
    Entry k of the stack is the product for start offset ``s = (k*R) mod T``;
    the device loop indexes it with ``(t-1) % product_period``. Products are
    accumulated in float64 and cast once, so the collapsed path carries one
    rounding step where the sequential path carries R.
    """
    R = int(rounds_per_iter)
    T = matrix_period(topology, n)
    singles = build_matrix_stack(topology, n).astype(np.float64)
    period = product_period(topology, n, R)
    out = np.empty((period, n, n), np.float64)
    for k in range(period):
        s = (k * R) % T
        M = np.eye(n)
        for r in range(R):
            M = M @ singles[(s + r) % T]
        out[k] = M.T
    return out.astype(np.float32)


def random_neighbor_matrix_device(n: int, *, targets: torch.Tensor,
                                  self_share: float = 0.5) -> torch.Tensor:
    """The paper's random one-neighbour mixing matrices from raw draws
    ``targets`` in [0, n − 1) of shape ``batch + (n,)`` on any device:
    ``batch + (n, n)`` float32 on that device.

    Each node keeps ``self_share`` of its mass and pushes the rest to one
    uniformly random *other* node (the draw, shifted past the node itself):
    row-stochastic, mass conserving under x' = Bᵀx. Same distribution as
    :func:`random_neighbor_matrix` for uniform draws.
    """
    device, batch = targets.device, tuple(targets.shape[:-1])
    if n == 1:
        return torch.ones(batch + (1, 1), dtype=torch.float32, device=device)
    nodes = torch.arange(n, device=device)
    targets = targets + (targets >= nodes).to(targets.dtype)  # uniform over others
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return (self_share * eye
            + (1.0 - self_share) * torch.nn.functional.one_hot(targets, n).to(torch.float32))

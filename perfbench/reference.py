"""The plain reference: GADGET (paper Algorithm 2) in plain PyTorch.

It imports nothing of the program. From the seed it draws every minibatch,
random-neighbour round and link failure itself (``threefry``, JAX's
streams as the program's documented semantics name them), then runs each
iteration as the paper writes it: margins and violators on the minibatch,
the Pegasos half-step, the projection onto the 1/sqrt(lambda) ball (step
f), R Push-Sum rounds x' = B^T x on the values n_i * w_i and the masses
n_i applied one after another, the renormalising divide, the projection
again (step h), and the running sum of the iterates. The consensus is the
data-weighted mean of the node weights.

Everything is float32 with TF32 off, as the configurations state, unless
``low=True`` (the control: the same arithmetic with every product's operands
rounded to TF32, one precision lower, whatever kernel would run it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench import threefry as tf

# the failure stream's salt in the program's documented key chain
FAULT_SALT = 0x0FA17
CHUNK = 50  # iterations whose draws are made together


class Fleet(NamedTuple):
    """One partitioned training set: ``X`` (m, n_i, d) dense or ``cols`` /
    ``vals`` (m, n_i, k) ELL planes, labels ``y`` (m, n_i) with 0 on padded
    rows, and the valid rows of each node ``counts`` (m,) int64."""

    y: torch.Tensor
    counts: torch.Tensor
    d: int
    X: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    vals: torch.Tensor | None = None

    @property
    def m(self) -> int:
        return self.y.shape[0]


class Settings(NamedTuple):
    """What a run states: lambda, the minibatch B, R rounds an iteration,
    the topology, the draws' 32-bit seed, and the fault plan (a dict with
    ``drop_prob``, ``drop``, ``dead_nodes`` and ``seed``) or None."""

    lam: float
    B: int
    R: int
    topology: str
    seed: int
    faults: dict | None = None


def step_scalars(lam: float, t: int, B: int) -> tuple[float, float]:
    """``(1 - lambda*alpha, alpha/B)`` with alpha = 1/(lambda t), each operation
    rounded to float32."""
    lam32 = np.float32(lam)
    alpha = np.float32(1.0) / (lam32 * np.float32(t))
    return float(np.float32(1.0) - lam32 * alpha), float(alpha / np.float32(B))


def project(W: torch.Tensor, lam: float) -> torch.Tensor:
    """Each row onto the ball of radius 1/sqrt(lambda)."""
    radius = float(np.float32(1.0) / np.sqrt(np.float32(lam)))
    norm = torch.linalg.vector_norm(W, dim=-1, keepdim=True)
    return W * torch.clamp(radius / torch.clamp(norm, min=1e-30), max=1.0)


class Draws:
    """The draws of iterations t from the seed: minibatch row ids and the
    R mixing matrices of each iteration, failures applied."""

    def __init__(self, s: Settings, counts: torch.Tensor):
        self.s, self.counts, self.dev = s, counts, counts.device
        base = tf.prng_key(s.seed)
        self.data_key, self.mix_key = tf.fold_in(base, 0), tf.fold_in(base, 1)
        self.m = counts.shape[0]

    def _ar(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int64, device=self.dev)

    def ids(self, t0: int, n: int) -> torch.Tensor:
        """(n, m, B): node i draws randint(fold_in(fold_in(data_key, t), i),
        (B,), 0, counts[i])."""
        t = (self._ar(n) + t0)[:, None, None]
        key = tf.fold_in(tf.fold_in(self.data_key, t), self._ar(self.m)[None, :, None])
        return tf.randint(key, self._ar(self.s.B)[None, None, :], self.counts[None, :, None])

    def rounds(self, t0: int, n: int) -> torch.Tensor:
        """(n, R, m, m) float32 round matrices B (x' = B^T x), faults applied."""
        m, R = self.m, self.s.R
        eye = torch.eye(m, dtype=torch.float32, device=self.dev)
        if self.s.topology == "random":
            t = (self._ar(n) + t0)[:, None, None]
            key = tf.fold_in(tf.fold_in(self.mix_key, t), self._ar(R)[None, :, None])
            target = tf.randint(key, self._ar(m)[None, None, :], m - 1)
            target = target + (target >= self._ar(m)).to(torch.int64)  # another node
            share = torch.nn.functional.one_hot(target, m).to(torch.float32)
        elif self.s.topology == "exponential":
            hops = max(1, int(np.ceil(np.log2(m))))
            g = (self._ar(n) + t0 - 1)[:, None] * R + self._ar(R)[None, :]
            target = (self._ar(m)[None, None, :] + (1 << (g % hops))[:, :, None]) % m
            share = torch.nn.functional.one_hot(target, m).to(torch.float32)
        else:
            raise ValueError(f"the reference draws no {self.s.topology!r} topology")
        B = 0.5 * eye + 0.5 * share
        if self.s.faults is not None:
            B = self._faulted(B, t0, n)
        return B

    def _faulted(self, B: torch.Tensor, t0: int, n: int) -> torch.Tensor:
        f = self.s.faults
        m, R = self.m, self.s.R
        eye = torch.eye(m, dtype=torch.bool, device=self.dev)
        dead = torch.zeros((m,), dtype=torch.bool, device=self.dev)
        dead[list(f.get("dead_nodes", ()))] = True
        stream = tf.fold_in(tf.prng_key(int(f["seed"])), FAULT_SALT)
        t = (self._ar(n) + t0)[:, None, None]
        key = tf.fold_in(tf.fold_in(stream, t), self._ar(R)[None, :, None])
        fail = tf.bernoulli(key, self._ar(m * m)[None, None, :], f["drop_prob"]).view(n, R, m, m)
        B = torch.where(dead[:, None], eye.to(torch.float32), B)  # a dead node keeps all
        fail = (fail | dead[None, :]) & ~eye  # links into a dead node fail too
        lost = torch.where(fail, B, 0.0)
        B = torch.where(fail, 0.0, B)
        if f["drop"] == "link":  # the sender keeps what it could not send
            B = B + torch.diag_embed(lost.sum(dim=-1))
        return B


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (a 10-bit mantissa, to nearest, ties to even), as
    a TF32 product rounds its float32 operands."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def half_step(fleet: Fleet, W: torch.Tensor, rows: torch.Tensor, lam: float, t: int,
              B: int, margins64: bool = False, low: bool = False) -> torch.Tensor:
    """Steps (a)-(f) for every node on its minibatch ``rows`` (m, B);
    ``margins64`` sums the margins in float64 before rounding them to
    float32 (a second, equally sound rounding of the same arithmetic);
    ``low`` takes every product's operands in TF32 (the control)."""
    m = fleet.m
    node = torch.arange(m, device=W.device)[:, None]
    yb = fleet.y[node, rows]
    rnd = tf32 if low else (lambda a: a)
    if fleet.X is not None:
        Xb = rnd(fleet.X[node, rows])
        if margins64:
            margins = (yb.double() * torch.bmm(Xb.double(), W.double()[:, :, None])[..., 0]).float()
        else:
            margins = yb * torch.bmm(Xb, rnd(W)[:, :, None])[..., 0]
        coeff = torch.where(margins < 1.0, yb, 0.0)
        grad = torch.bmm(coeff[:, None, :], Xb)[:, 0, :]
    else:
        cb = fleet.cols[node, rows].long().reshape(m, -1)
        vb = rnd(fleet.vals[node, rows])
        wb = rnd(W.gather(1, cb).view(vb.shape))
        if margins64:
            margins = (yb.double() * (vb.double() * wb.double()).sum(-1)).float()
        else:
            margins = yb * (vb * wb).sum(-1)
        coeff = torch.where(margins < 1.0, yb, 0.0)
        grad = torch.zeros_like(W).scatter_add_(1, cb, (coeff[..., None] * vb).reshape(m, -1))
    decay, scale = step_scalars(lam, t, B)
    return project(decay * W + scale * grad, lam)


def segment(fleet: Fleet, s: Settings, W: torch.Tensor, W_sum: torch.Tensor, t0: int,
            n: int, *, low: bool = False,
            margins64: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterations t0 ... t0+n-1 from ``(W, W_sum)``; returns the new pair.
    ``low``: every product in TF32, the half-step's and the mix's."""
    draws = Draws(s, fleet.counts)
    mass = fleet.counts.to(torch.float32)
    dead = torch.zeros((fleet.m,), dtype=torch.bool, device=W.device)
    if s.faults is not None:
        dead[list(s.faults.get("dead_nodes", ()))] = True
    rnd = tf32 if low else (lambda a: a)
    for c0 in range(t0, t0 + n, CHUNK):
        c = min(CHUNK, t0 + n - c0)
        ids, rounds = draws.ids(c0, c), draws.rounds(c0, c)
        for k in range(c):
            t = c0 + k
            v = half_step(fleet, W, ids[k], s.lam, t, s.B, margins64, low) * mass[:, None]
            w = mass
            for r in range(s.R):
                Bt = rnd(rounds[k, r].T)
                v, w = Bt @ rnd(v), Bt @ rnd(w)
            W = torch.where(dead[:, None], W, project(v / w[:, None], s.lam))
            W_sum = W_sum + W
    return W, W_sum


def consensus(fleet: Fleet, W: torch.Tensor) -> torch.Tensor:
    """The data-weighted mean of the node weights."""
    n = fleet.counts.to(torch.float32)
    return (W * n[:, None]).sum(0) / n.sum()


def objective(fleet: Fleet, w: torch.Tensor, lam: float) -> float:
    """lambda/2 |w|^2 plus the mean hinge loss over every valid training row,
    in float64."""
    w64 = w.double()
    total, hinge = 0, 0.0
    for i in range(fleet.m):
        c = int(fleet.counts[i])
        if fleet.X is not None:
            z = fleet.X[i, :c].double() @ w64
        else:
            z = (fleet.vals[i, :c].double() * w64[fleet.cols[i, :c].long()]).sum(-1)
        hinge += float(torch.clamp(1.0 - fleet.y[i, :c].double() * z, min=0.0).sum())
        total += c
    return 0.5 * lam * float(w64 @ w64) + hinge / total


def scores(w: torch.Tensor, X=None, cols=None, vals=None, *, low: bool = False) -> torch.Tensor:
    """Test scores <w, x> of dense rows ``X`` or ELL planes, in float64, or
    with ``low`` from TF32 operands summed in float32 (the control)."""
    if low:
        w32 = tf32(w)
        if X is not None:
            return tf32(X) @ w32
        return (tf32(vals) * w32[cols.long()]).sum(-1)
    w64 = w.double()
    if X is not None:
        return X.double() @ w64
    return (vals.double() * w64[cols.long()]).sum(-1)

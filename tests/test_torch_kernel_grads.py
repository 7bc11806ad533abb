"""Gradients through the transformer kernels' wrappers (B10
``flash_attention``, B11 ``rglru_scan``, B12 ``wkv_scan``).

Each wrapper is a registered operator with an autograd formula: B11's
backward is the same scan run backwards in time
(``rglru_scan_backward``), B10's and B12's are backward operators, the
plain versions' vector-Jacobian products written out
(``flash_attention_backward_plain``, ``wkv_scan_backward_plain``), which
the card runs too. Here, on the CPU, the reverse scan runs with
``rglru_scan_plain`` standing in for the kernel against autograd through
the plain scan, and the wrappers' gradients are held against ``jax.grad``
of the reference's oracles, bit for bit against the written-out products
and to rounding against autograd through the plain versions. The card's
operators themselves are held in ``chip_smoke.py`` phase 3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ref as ref_fa  # noqa: E402
from repro.kernels.rglru_scan import ref as ref_rg  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_wkv  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward_plain, flash_attention_plain)
from repro_torch.kernels.rglru_scan.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_backward, rglru_scan_plain)
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (  # noqa: E402
    wkv_scan, wkv_scan_backward_plain, wkv_scan_plain)

GRAD_ATOL = 1e-5
PLAIN_ATOL = 1e-6  # the written-out backward against autograd through the plain version


def _rand(rng, *shape, lo=None, hi=None, scale=1.0):
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("B,S,D", [(2, 37, 5), (1, 1, 3), (3, 64, 16)])
def test_reverse_scan_backward_matches_autograd(B, S, D):
    """The adjoint of h_t = a_t h_{t-1} + b_t as one forward scan on the
    time-flipped inputs, against autograd through the plain scan: equal
    within 1e-6 (each step a multiply and an add, both ways)."""
    rng = np.random.default_rng(S)
    a = torch.from_numpy(_rand(rng, B, S, D, lo=0.5, hi=0.999)).requires_grad_()
    b = torch.from_numpy(_rand(rng, B, S, D)).requires_grad_()
    dh = torch.from_numpy(_rand(rng, B, S, D))
    h = rglru_scan_plain(a, b)
    want_da, want_db = torch.autograd.grad(h, (a, b), dh)
    da, db = rglru_scan_backward(a.detach(), h.detach(), dh, scan=rglru_scan_plain)
    np.testing.assert_allclose(db.numpy(), want_db.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(da.numpy(), want_da.numpy(), rtol=0, atol=1e-6)


def test_rglru_scan_gradients_match_reference():
    rng = np.random.default_rng(0)
    a, b, dh = _rand(rng, 2, 29, 8, lo=0.5, hi=0.999), _rand(rng, 2, 29, 8), _rand(rng, 2, 29, 8)
    want = jax.grad(lambda a, b: jnp.sum(ref_rg.scan_ref(a, b) * dh), argnums=(0, 1))(a, b)
    at, bt = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = torch.autograd.grad(rglru_scan(at, bt), (at, bt), torch.from_numpy(dh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal,window,hkv", [(True, 0, 2), (True, 5, 1), (False, 0, 4)])
def test_flash_attention_gradients_match_reference(causal, window, hkv):
    """q, k, v gradients of the wrapper (the plain version on the CPU, the
    card's backward) against ``jax.grad`` of the reference's oracle, the
    grouped heads read through their kv head."""
    B, S, H, dh = 2, 13, 4, 8
    rng = np.random.default_rng(hkv)
    q, k, v = _rand(rng, B, S, H, dh), _rand(rng, B, S, hkv, dh), _rand(rng, B, S, hkv, dh)
    d_out = _rand(rng, B, S, H, dh)
    rep = H // hkv

    def ref(q, k, v):  # (B, S, H, dh) through the oracle's (BH, S, dh) planes
        kk, vv = (jnp.repeat(x, rep, axis=2) for x in (k, v))
        planes = [jnp.transpose(x, (0, 2, 1, 3)).reshape(B * H, S, dh) for x in (q, kk, vv)]
        o = ref_fa.attention_ref(*planes, causal=causal, window=window)
        return jnp.transpose(o.reshape(B, H, S, dh), (0, 2, 1, 3))

    want = jax.grad(lambda *x: jnp.sum(ref(*x) * d_out), argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(d_out))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_ATOL)
    # the backward is the backward operator's written-out product, which the
    # card runs too, bit for bit; autograd through the plain version agrees
    # to rounding
    card = flash_attention_backward_plain(qt.detach(), kt.detach(), vt.detach(),
                                          torch.from_numpy(d_out), causal=causal, window=window)
    again = torch.autograd.grad(flash_attention_plain(qt, kt, vt, causal=causal, window=window),
                                (qt, kt, vt), torch.from_numpy(d_out))
    for g, c, w in zip(got, card, again):
        assert torch.equal(g, c)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("B,S,H,n", [(2, 11, 3, 4), (1, 1, 2, 8)])
def test_wkv_scan_gradients_match_reference(B, S, H, n):
    rng = np.random.default_rng(S)
    r, k, v = (_rand(rng, B, S, H, n, scale=0.3) for _ in range(3))
    w = _rand(rng, B, S, H, n, lo=0.8, hi=0.999)
    u = _rand(rng, H, n, scale=0.1)
    d_out = _rand(rng, B, S, H, n)
    want = jax.grad(lambda *x: jnp.sum(ref_wkv.scan_ref(*x) * d_out),
                    argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
    ts = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    got = torch.autograd.grad(wkv_scan(*ts), ts, torch.from_numpy(d_out), materialize_grads=True)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=GRAD_ATOL)
    card = wkv_scan_backward_plain(*(t.detach() for t in ts), torch.from_numpy(d_out))
    again = torch.autograd.grad(wkv_scan_plain(*ts), ts, torch.from_numpy(d_out),
                                materialize_grads=True)
    for g, c, w_ in zip(got, card, again):
        assert torch.equal(g, c)
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0, atol=PLAIN_ATOL)

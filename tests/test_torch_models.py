"""The port's model layers and blocks against the reference's on the same
weights: params drawn by the reference, carried across with
``repro_torch.convert.load_params``, and the same numpy inputs through both.
Tolerance 1e-5, except where a bound is stated with its reason."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro.models import rwkv6 as RW  # noqa: E402
from repro_torch.convert import load_params  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rglru as TG  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402

ATOL = 1e-5
# rglru_train: the reference runs an associative scan, the port a sequential
# one (its kernel's function); over 40 steps their roundings differ by a few
# ulps of h, which the output projection carries: 5e-5 bounds it
RGLRU_TRAIN_ATOL = 5e-5
D, B, S = 64, 2, 40


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("d", [5, 64])
def test_norms(d, with_bias):
    x = _x(3, 7, d, seed=d)
    p = RL.init_norm(d, with_bias=with_bias)
    rng = np.random.default_rng(1)
    p = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in p.items()}
    m = load_params(TL.Norm(d, with_bias=with_bias), _np(p))
    _close(TL.layer_norm(m, torch.from_numpy(x)), RL.layer_norm(p, jnp.asarray(x)))
    _close(TL.rms_norm(m, torch.from_numpy(x)), RL.rms_norm(p, jnp.asarray(x)))


def test_layer_norm_uses_the_population_variance():
    x = _x(1, 5, seed=3)
    m = TL.Norm(5)
    want = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-5)  # ddof 0
    _close(TL.layer_norm(m, torch.from_numpy(x)), want, atol=1e-6)


@pytest.mark.parametrize("kind", ["gated_silu", "squared_relu", "gelu"])
def test_mlp(kind):
    p = RL.init_mlp(jax.random.PRNGKey(0), D, 3 * D, kind)
    m = load_params(TL.MLP(D, 3 * D, kind), _np(p))
    x = _x(B, S, D)
    _close(m(torch.from_numpy(x)), RL.mlp_apply(p, jnp.asarray(x), kind))


def test_gelu_is_the_tanh_approximation():
    p = RL.init_mlp(jax.random.PRNGKey(0), D, 3 * D, "gelu")
    m = load_params(TL.MLP(D, 3 * D, "gelu"), _np(p))
    x = torch.from_numpy(_x(B, S, D, scale=3.0))
    exact = torch.matmul(torch.nn.functional.gelu(torch.matmul(x, m.wi.w)), m.wo.w)
    assert float((m(x) - exact).detach().abs().max()) > 1e-4  # the erf form would fail test_mlp


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rotary_and_embeddings(theta):
    x = _x(B, S, 4, 16, seed=2)
    pos = np.broadcast_to(np.arange(S) + 3, (B, S))
    _close(TL.rotary(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta),
           RL.rotary(jnp.asarray(x), jnp.asarray(pos), theta))
    p = RL.init_embedding(jax.random.PRNGKey(4), 50, D)
    e = load_params(TL.Embedding(50, D), _np(p))
    toks = np.random.default_rng(0).integers(0, 50, (B, S))
    _close(TL.embed(e, torch.from_numpy(toks)), RL.embed(p, jnp.asarray(toks)))
    h = _x(B, S, D, seed=5)
    _close(TL.unembed(e, torch.from_numpy(h)), RL.unembed(p, jnp.asarray(h)))


def test_rotary_rotates_halves_not_pairs():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0  # the first element of the first half
    out = TL.rotary(x, torch.ones(1, 1, dtype=torch.int32))
    assert abs(float(out[..., 2]) - np.sin(1.0)) < 1e-6  # it moves into the second half
    assert float(out[..., 1]) == 0.0


# ---------------------------------------------------------------- attention

def _attn(h=4, hkv=2, dh=16, seed=0):
    p = RA.init_attention(jax.random.PRNGKey(seed), D, h, hkv, dh)
    return p, load_params(TA.Attention(D, h, hkv, dh), _np(p))


@pytest.mark.parametrize("window,causal", [(0, True), (8, True), (0, False), (64, True)])
def test_attention_train(window, causal):
    p, m = _attn()
    x = _x(B, S, D)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    want = jax.jit(RA.attention_train, static_argnames=("window", "causal"))(
        p, jnp.asarray(x), jnp.asarray(pos), window=window, causal=causal)
    got = TA.attention_train(m, torch.from_numpy(x), torch.from_numpy(pos), window=window,
                             causal=causal)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode(window):
    """Step by step past the window: the ring cache and the mask agree."""
    p, m = _attn(hkv=1, seed=1)
    steps = 20
    xs = _x(B, steps, D, seed=2)
    rc = RA.init_kv_cache(B, steps, 1, 16, window, jnp.float32)
    tc = TA.init_kv_cache(B, steps, 1, 16, window, torch.float32)
    assert tc.size == rc.size == (window or steps)
    decode = jax.jit(lambda *a: RA.attention_decode(*a, window=window))
    for t in range(steps):
        want, rc = decode(p, jnp.asarray(xs[:, t:t + 1]), rc, jnp.int32(t))
        got, tc = TA.attention_decode(m, torch.from_numpy(xs[:, t:t + 1]), tc, t, window=window)
        _close(got, want)
    _close(tc.k, rc.k)
    _close(tc.v, rc.v)


def test_attention_decode_with_a_bf16_cache():
    """The reference's default cache type: the probabilities in bf16, as JAX
    promotes them."""
    p, m = _attn(hkv=1, seed=3)
    xs = _x(B, 6, D, seed=4)
    rc = RA.init_kv_cache(B, 6, 1, 16, 0)
    tc = TA.init_kv_cache(B, 6, 1, 16, 0)
    assert tc.k.dtype == torch.bfloat16
    for t in range(6):
        want, rc = RA.attention_decode(p, jnp.asarray(xs[:, t:t + 1]), rc, jnp.int32(t))
        got, tc = TA.attention_decode(m, torch.from_numpy(xs[:, t:t + 1]), tc, t)
        _close(got, want, atol=2e-2)  # bf16 rounding of probabilities and cache


# -------------------------------------------------------------------- rglru

def _rglru(seed=0):
    p = RG.init_rglru_block(jax.random.PRNGKey(seed), D)
    return p, load_params(TG.RGLRU(D), _np(p))


def test_rglru_train():
    p, m = _rglru()
    x = _x(B, S, D, seed=1)
    _close(TG.rglru_train(m, torch.from_numpy(x)), jax.jit(RG.rglru_train)(p, jnp.asarray(x)),
           atol=RGLRU_TRAIN_ATOL)


def test_rglru_pieces():
    p, m = _rglru(seed=2)
    u = _x(B, S, D, seed=3)
    _close(TG._conv1d_train(m, torch.from_numpy(u)), RG._conv1d_train(p, jnp.asarray(u)))
    for got, want in zip(TG._gates(m, torch.from_numpy(u)), RG._gates(p, jnp.asarray(u))):
        _close(got, want)


def test_rglru_decode():
    p, m = _rglru(seed=4)
    xs = _x(B, 12, D, seed=5)
    rs, ts = RG.init_rglru_state(B, D), TG.init_rglru_state(B, D)
    for t in range(12):
        want, rs = RG.rglru_decode(p, jnp.asarray(xs[:, t:t + 1]), rs)
        got, ts = TG.rglru_decode(m, torch.from_numpy(xs[:, t:t + 1]), ts)
        _close(got, want)
    _close(ts.h, rs.h)
    _close(ts.conv, rs.conv)


def test_rglru_init_matches_the_reference_distributions():
    m = TG.init_rglru_block(torch.Generator().manual_seed(0), 512)
    a_max = torch.exp(-8.0 * torch.nn.functional.softplus(getattr(m, "lambda").detach()))  # a at r = 1
    assert float(a_max.min()) >= 0.9 - 1e-5 and float(a_max.max()) <= 0.999 + 1e-5
    assert abs(float(m.w_a.detach().std()) * np.sqrt(512) - 1.0) < 0.05
    assert abs(float(m.conv_w.detach().std()) - 0.5) < 0.05 and not bool(m.b_a.any())


# -------------------------------------------------------------------- rwkv6

def _rwkv(seed=0, n=16):
    p = RW.init_rwkv6_block(jax.random.PRNGKey(seed), D, 3 * D, n)
    return p, load_params(TW.RWKV6(D, 3 * D, n), _np(p))


@pytest.mark.parametrize("n", [16, 64])
def test_rwkv_train(n):
    p, m = _rwkv(n=n)
    x = _x(B, S, D, seed=6)
    _close(TW.time_mix_train(m, torch.from_numpy(x), n),
           jax.jit(RW.time_mix_train, static_argnums=2)(p, jnp.asarray(x), n))
    _close(TW.channel_mix_train(m, torch.from_numpy(x)), RW.channel_mix_train(p, jnp.asarray(x)))


def test_rwkv_decode():
    p, m = _rwkv(seed=1)
    xs = _x(B, 10, D, seed=7)
    rs, ts = RW.init_rwkv6_state(B, D, 16), TW.init_rwkv6_state(B, D, 16)
    for t in range(10):
        xt = xs[:, t:t + 1]
        want_tm, rs = RW.time_mix_decode(p, jnp.asarray(xt), rs, 16)
        got_tm, ts = TW.time_mix_decode(m, torch.from_numpy(xt), ts, 16)
        want_cm, rs = RW.channel_mix_decode(p, jnp.asarray(xt), rs)
        got_cm, ts = TW.channel_mix_decode(m, torch.from_numpy(xt), ts)
        _close(got_tm, want_tm)
        _close(got_cm, want_cm)
    _close(ts.S, rs.S)


def test_rwkv_init_matches_the_reference_constants():
    p = RW.init_rwkv6_block(jax.random.PRNGKey(0), D, 3 * D, 16)
    m = TW.init_rwkv6_block(torch.Generator().manual_seed(0), D, 3 * D, 16)
    for name in ("decay_base", "mu_r", "cm_mu", "ln_x_scale"):
        _close(getattr(m, name), p[name], atol=1e-6)
    assert m.bonus_u.dtype == torch.float32 and tuple(m.bonus_u.shape) == p["bonus_u"].shape

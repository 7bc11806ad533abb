"""The port's flash attention against the reference's Pallas kernel, run in
interpret mode, and against its oracle. On CPU tensors the port's wrapper
takes the kernel's plain version, which is what these tests hold to the
reference (the CUDA kernel itself is held to the plain version on the card
by chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import gqa_flash_attention as ref_gqa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (gqa_flash_attention, launch_cost,  # noqa: E402
                                                     live_pairs)
from repro_torch.kernels.flash_attention.ref import (attention_ref, attention_tf32,  # noqa: E402
                                                     tf32_matmul, tf32_round)

# the reference test's shapes (tests/test_kernels.py::TestFlashAttention) and tolerances
SHAPES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 4, 1, 64, True, 64),
    (2, 64, 2, 2, 32, False, 0),
    (1, 128, 8, 4, 128, True, 32),
    (1, 96, 2, 1, 16, True, 0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, s, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32))


def _planes(x, h):
    """(B, S, Hx, dh) numpy -> the reference kernel's (B*H, S, dh), kv heads repeated."""
    b, s, hx, dh = x.shape
    x = np.repeat(x, h // hx, axis=2)
    return np.moveaxis(x, 2, 1).reshape(b * h, s, dh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,dh,causal,window", SHAPES)
def test_matches_reference_kernel(b, s, h, hkv, dh, causal, window, dtype):
    q, k, v = _qkv(b, s, h, hkv, dh)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_gqa(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal, window=window,
                   blk_q=32, blk_k=32, interpret=True)
    got = gqa_flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, dh)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("dh", [80, 40, 33])
def test_head_sizes_between_instantiations_match_reference_kernel(dh):
    """Head sizes the kernel pads to its next instantiation (80 is
    hubert-xlarge's; 33 fills no 16-byte chunk), f32 at the reference
    test's 2e-5."""
    b, s, h, hkv = 1, 96, 4, 2
    q, k, v = _qkv(b, s, h, hkv, dh, seed=dh)
    want = ref_gqa(*(jnp.asarray(x) for x in (q, k, v)), causal=True, window=32,
                   blk_q=32, blk_k=32, interpret=True)
    got = gqa_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=32)
    assert tuple(got.shape) == (b, s, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_head_size_limit_is_named():
    """The launch path takes every dh from 1 to MAX_HEAD_DIM and raises
    above it, naming the limit, before it builds or launches anything."""
    assert FA.MAX_HEAD_DIM == 256
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 1, 257))
    with pytest.raises(ValueError, match="1..256"):
        FA._launch(q, k, v, causal=True, window=0)


@pytest.mark.parametrize("s,window,causal", [(100, 0, True), (100, 16, True), (37, 64, True),
                                             (37, 64, False), (100, 250, True)])
def test_any_length_matches_oracle(s, window, causal):
    """Lengths the reference's wrapper cannot take (S % blk != 0) and windows
    wider than S, against the reference's oracle."""
    b, h, hkv, dh = 2, 4, 2, 32
    q, k, v = _qkv(b, s, h, hkv, dh, seed=s + window)
    want = ref_attention(*(jnp.asarray(_planes(x, h)) for x in (q, k, v)), causal=causal,
                         window=window)
    want = np.moveaxis(np.asarray(want).reshape(b, h, s, dh), 1, 2)
    got = gqa_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # a window wider than the sequence masks nothing beyond causality
    if window >= s:
        plain = gqa_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)


def test_port_oracle_matches_reference_oracle():
    q, k, v = (x[:, :, 0] for x in _qkv(3, 50, 1, 1, 16, seed=5))
    for causal, window in ((True, 0), (True, 7), (False, 9)):
        want = ref_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window)
        got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_plain_version_does_not_count_and_strided_views_agree():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 40, 4, 2, 32, seed=3))
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, causal=True, window=8)
    assert FA.flash_attention.launches == before  # CPU tensors: the plain version, no launch
    # a (B, H, S, dh) tensor seen through a transpose gives the same result
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    torch.testing.assert_close(FA.flash_attention(qt, k, v, causal=True, window=8), out)


def test_rejects_bad_shapes_and_devices():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 16))
    with pytest.raises(TypeError):
        FA.flash_attention(q.double(), k.double(), v.double())
    before = FA.flash_attention.launches
    out = FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))  # the fake: shapes only
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    assert FA.flash_attention.launches == before
    with pytest.raises(ValueError, match="different devices"):
        FA.flash_attention(q, k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("s,causal,window", [(1, True, 0), (17, True, 0), (17, False, 0),
                                             (40, True, 8), (40, False, 8), (10, True, 64)])
def test_launch_cost_counts_live_pairs(s, causal, window):
    mask = FA.band_mask(s, s, causal=causal, window=window)
    assert live_pairs(s, causal=causal, window=window) == int(mask.sum())
    cost = launch_cost(B=2, S=s, H=4, Hkv=2, dh=32, causal=causal, window=window)
    assert cost["flops"] == 4 * 32 * 4 * 2 * int(mask.sum())
    assert cost["bytes"] == 4 * 2 * s * 32 * (2 * 4 + 2 * 2)


@pytest.mark.parametrize("x,want", [(1.0, 1.0), (1 + 2.0 ** -11, 1 + 2.0 ** -10),
                                    (1 + 2.0 ** -12, 1.0), (-(1 + 3 * 2.0 ** -12), -(1 + 2.0 ** -10)),
                                    (3.14159265, 3.140625), (0.0, 0.0)])
def test_split_tf32_rounding_is_cvt_rna(x, want):
    """Half away from zero at 10 mantissa bits, the low 13 bits cleared."""
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want
    assert int(got.view(torch.int32)[0]) & 0x1FFF == 0


def test_split_tf32_three_terms_recover_f32_products():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 48)).astype(np.float32))
    exact = (a.double() @ b.double()).float()
    scale = float(exact.abs().max())
    assert float((tf32_matmul(a, b, terms=3) - exact).abs().max()) / scale < 1e-6
    assert float((tf32_matmul(a, b, terms=1) - exact).abs().max()) / scale > 1e-4


def _attention_f64(q, k, v, *, causal, window):
    q, k, v = (x.double() for x in (q, k, v))
    s, dh = q.shape[1], q.shape[2]
    scores = q @ k.transpose(1, 2) / np.sqrt(dh)
    mask = FA.band_mask(s, s, causal=causal, window=window)
    return torch.softmax(scores.masked_fill(~mask, FA.NEG_INF), dim=-1) @ v


@pytest.mark.parametrize("s,causal,window", [(384, True, 0), (384, True, 128), (256, False, 0)])
def test_split_tf32_attention_within_kernel_tolerance(s, causal, window):
    """At dh = 256 the kernel's 3-term split is as close to the exact
    (float64) attention as the f32 plain version is, within 1e-6, and one
    TF32 product misses the port's 1e-5 tolerance: why the f32 route splits
    every operand."""
    rng = np.random.default_rng(s + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 256)).astype(np.float32))
               for _ in range(3))
    exact = _attention_f64(q, k, v, causal=causal, window=window)
    scale = max(1.0, float(exact.abs().max()))

    def err(got):
        return float((got.double() - exact).abs().max()) / scale
    assert err(attention_ref(q, k, v, causal=causal, window=window)) <= 1e-6
    assert err(attention_tf32(q, k, v, terms=3, causal=causal, window=window)) <= 1e-6
    assert err(attention_tf32(q, k, v, terms=1, causal=causal, window=window)) > 1e-5

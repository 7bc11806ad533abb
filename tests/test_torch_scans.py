"""The port's RG-LRU and WKV scans against the reference's Pallas kernels,
run in interpret mode, at the shapes of tests/test_kernels.py, and against
the reference's oracles on random shapes. On CPU tensors the port's
wrappers take their kernels' plain versions (the CUDA kernels are held to
those on the card by chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.kernels.rglru_scan.ops import linear_recurrence as ref_linear_recurrence  # noqa: E402
from repro.kernels.rglru_scan.ref import scan_ref as ref_rglru  # noqa: E402
from repro.kernels.rwkv6_scan.ops import wkv as ref_wkv  # noqa: E402
from repro.kernels.rwkv6_scan.ref import scan_ref as ref_wkv_oracle  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as RO  # noqa: E402
from repro_torch.kernels.rglru_scan.rglru_scan import copy_width, rglru_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as WO  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as WK  # noqa: E402
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import wkv_scan  # noqa: E402


def _ab(B, S, D, seed, lo=0.8):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, 0.999, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32))


def _rkvwu(B, S, H, n, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.normal(size=(B, S, H, n)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.8, 0.999, size=(B, S, H, n)).astype(np.float32)
    u = 0.1 * rng.normal(size=(H, n)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,S,D,bs,bd", [
    (2, 64, 128, 16, 64), (1, 100, 70, 32, 32), (3, 256, 256, 128, 128), (1, 17, 130, 8, 128),
])
def test_linear_recurrence_matches_reference_kernel(B, S, D, bs, bd):
    a, b = _ab(B, S, D, seed=B * S + D)
    want = ref_linear_recurrence(jnp.asarray(a), jnp.asarray(b), blk_s=bs, blk_d=bd,
                                 interpret=True)
    got = RO.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 3), st.integers(1, 70), st.integers(1, 80))
def test_linear_recurrence_property(B, S, D):
    a, b = _ab(B, S, D, seed=7 * B + 11 * S + D, lo=0.0)
    got = RO.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_rglru(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)
    # h_0 = b_0: the carry starts at zero
    np.testing.assert_array_equal(got[:, 0].numpy(), b[:, 0])


@pytest.mark.parametrize("B,S,H,n,bs", [
    (2, 64, 2, 16, 16), (1, 100, 3, 32, 32), (2, 128, 2, 64, 64), (1, 33, 1, 8, 16),
])
def test_wkv_matches_reference_kernel(B, S, H, n, bs):
    r, k, v, w, u = _rkvwu(B, S, H, n, seed=B * S + H * n)
    want = ref_wkv(*(jnp.asarray(x) for x in (r, k, v, w, u)), blk_s=bs, interpret=True)
    got = WO.wkv(*(torch.from_numpy(x) for x in (r, k, v, w, u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n", [24, 40, 80])
def test_wkv_head_sizes_between_powers_of_two_match_reference(n):
    """Head sizes the kernel took only from PR 16 on (24: reduced rwkv6
    configs; 40, 80), against the reference's kernel (2e-5) and oracle (1e-5)."""
    r, k, v, w, u = _rkvwu(2, 20, 2, n, seed=n)
    args = [jnp.asarray(x) for x in (r, k, v, w, u)]
    got = WO.wkv(*(torch.from_numpy(x) for x in (r, k, v, w, u))).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_wkv(*args, blk_s=8, interpret=True)), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref_wkv_oracle(*args)), atol=1e-5)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 2), st.integers(1, 40), st.integers(1, 3), st.sampled_from([4, 8, 16]))
def test_wkv_property(B, S, H, n):
    r, k, v, w, u = _rkvwu(B, S, H, n, seed=5 * B + 13 * S + 3 * H + n)
    got = WO.wkv(*(torch.from_numpy(x) for x in (r, k, v, w, u)))
    want = ref_wkv_oracle(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # out_0 = r_0 diag(u) k_0^T v_0: the state starts at zero
    first = np.einsum("bhi,hi,bhi,bhj->bhj", r[:, 0], u, k[:, 0], v[:, 0])
    np.testing.assert_allclose(got[:, 0].numpy(), first, atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu_and_reject_other_devices():
    a, b = (torch.from_numpy(x) for x in _ab(1, 5, 3, seed=0))
    before = rglru_scan.launches
    rglru_scan(a, b)
    assert rglru_scan.launches == before
    with pytest.raises(ValueError, match="different devices"):
        rglru_scan(a, b.to("meta"))
    r, k, v, w, u = (torch.from_numpy(x) for x in _rkvwu(1, 5, 2, 8, seed=0))
    before = wkv_scan.launches
    wkv_scan(r, k, v, w, u)
    assert wkv_scan.launches == before
    out = wkv_scan(*(x.to("meta") for x in (r, k, v, w, u)))  # the fake: shapes only
    assert out.device.type == "meta" and out.shape == r.shape
    assert wkv_scan.launches == before
    with pytest.raises(ValueError, match="different devices"):
        wkv_scan(r, k, v, w, u.to("meta"))


@pytest.mark.parametrize("D,width", [(1, 1), (130, 1), (4096, 4), (4100, 4)])
def test_rglru_copy_width(D, width):
    """The scan stages a and b with 16-byte copies only when every row
    (D floats) and both inputs start on 16 bytes: D = 130's 520-byte rows
    and D = 1 take 4-byte copies, and so does any input off a 16-byte
    boundary."""
    assert copy_width(D) == width
    assert copy_width(D, 0, 256) == width
    assert copy_width(D, 1024, 4) == 1
    assert copy_width(D, 8, 0) == 1


def test_wkv_scan_names_its_head_size_limit():
    """Every n from 1 to MAX_HEAD_SIZE is taken; above it the launch path
    raises, naming the limit, before it builds or launches anything."""
    assert WK.MAX_HEAD_SIZE == 256
    big = torch.zeros((1, 2, 1, 257))
    with pytest.raises(ValueError, match="1..256"):
        WK._launch(big, big, big, big, torch.zeros((1, 257)))


def test_launch_costs():
    assert RO.launch_cost(B=2, S=4096, D=4096) == {
        "launches": 1, "bytes": 12 * 2 * 4096 * 4096, "flops": 2 * 2 * 4096 * 4096}
    c = WO.launch_cost(B=2, S=4096, H=40, n=64)
    assert c["bytes"] == 4 * (5 * 2 * 4096 * 40 * 64 + 40 * 64)
    assert c["flops"] == 2 * 4096 * 40 * (5 * 64 * 64 + 5 * 64)

"""The port's gossip pieces against ``repro.core.topology`` and ``push_sum``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import push_sum as RP  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro_torch.core import push_sum as TP  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("topology", list(RT.DETERMINISTIC_TOPOLOGIES))
def test_stacks_equal_reference(topology, n):
    np.testing.assert_array_equal(TT.build_matrix_stack(topology, n),
                                  RT.build_matrix_stack(topology, n))
    for R in (1, 3, 4):
        np.testing.assert_array_equal(TT.build_product_stack(topology, n, R),
                                      RT.build_product_stack(topology, n, R))


@pytest.mark.parametrize("topology", list(RT.TOPOLOGIES))
def test_host_matrix_equals_reference(topology):
    a = TT.build_matrix(topology, 7, t=3, rng=np.random.default_rng(4))
    b = RT.build_matrix(topology, 7, t=3, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collapsed_mix_matches_reference_mix_rounds(seed):
    rng = np.random.default_rng(seed)
    n, R = 3 + seed * 2, 1 + seed
    Bs = np.stack([RT.random_neighbor_matrix(n, rng) for _ in range(R)]).astype(np.float32)
    v = rng.normal(size=(n, 6)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    v_ref, w_ref = RP.mix_rounds(jnp.asarray(v), jnp.asarray(w), jnp.asarray(Bs))
    tv, tw, tB = map(torch.from_numpy, (v, w, Bs))
    P = TP.collapse_rounds(tB)
    np.testing.assert_allclose(P.numpy(), np.asarray(RP.collapse_rounds(jnp.asarray(Bs))),
                               atol=1e-6)
    for v_port, w_port in (TP.mix_collapsed(tv, tw, P), TP.mix_rounds(tv, tw, tB)):
        np.testing.assert_allclose(v_port.numpy(), np.asarray(v_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(w_port.numpy(), np.asarray(w_ref), rtol=1e-6, atol=1e-6)


def test_collapse_rounds_batches_leading_axes():
    rng = np.random.default_rng(5)
    Bs = torch.from_numpy(rng.random((6, 3, 4, 4)).astype(np.float32))
    P = TP.collapse_rounds(Bs)
    for k in range(6):
        torch.testing.assert_close(P[k], TP.collapse_rounds(Bs[k]))


@pytest.mark.parametrize("n", [1, 2, 3, 10])
def test_device_random_matrix_is_one_neighbour_protocol(n):
    gen = torch.Generator().manual_seed(n)
    targets = torch.randint(0, max(n - 1, 1), (50, 4, n), generator=gen)
    Bs = TT.random_neighbor_matrix_device(n, targets=targets)
    assert Bs.shape == (50, 4, n, n) and Bs.dtype == torch.float32
    torch.testing.assert_close(Bs.sum(-1), torch.ones(50, 4, n))  # row-stochastic
    if n == 1:
        return
    diag = torch.diagonal(Bs, dim1=-2, dim2=-1)
    assert torch.all(diag == 0.5)  # self_share kept
    off = Bs - torch.diag_embed(diag)
    assert torch.all((off > 0).sum(-1) == 1)  # exactly one other node per row
    assert torch.all(off.max(-1).values == 0.5)
    if n > 2:  # every other node is reached by some draw
        reached = (off > 0).reshape(-1, n, n).any(0)
        assert torch.all(reached == ~torch.eye(n, dtype=torch.bool))

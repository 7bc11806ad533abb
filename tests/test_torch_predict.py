"""The port's dense_predict against the reference's fused dense_scores
kernel (interpret mode), binary and multiclass, ties included."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hinge_subgrad import ops as RO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import ops as TO  # noqa: E402
from repro_torch.kernels.hinge_subgrad import predict as TP  # noqa: E402


def _inputs(B, d, C, seed=0):
    rng = np.random.default_rng(seed + B + d + C)
    X = (rng.normal(size=(B, d)) / np.sqrt(d)).astype(np.float32)
    W = rng.normal(size=(C, d)).astype(np.float32)
    if C > 1:
        W[C - 1] = W[0]          # classes 0 and C-1 tie on every row
    X[0] = 0.0                   # an all-zero query: every class scores 0
    return X, W


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("B,d", [(1, 100), (5, 130), (37, 300)])
def test_dense_predict(B, d, C):
    X, W = _inputs(B, d, C)
    Wq = W[0] if C == 1 else W
    s_ref, l_ref = RO.dense_predict(jnp.asarray(Wq), jnp.asarray(X), interpret=True)
    s_port, l_port = TO.dense_predict(torch.from_numpy(Wq), torch.from_numpy(X))
    assert s_port.shape == s_ref.shape and l_port.shape == l_ref.shape
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    assert l_port.dtype == (torch.float32 if C == 1 else torch.int32)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    if C == 1:
        assert l_port[0] == 1.0  # margin 0 labels +1
    else:
        assert l_port[0] == 0    # an all-way tie takes the first class
        assert not torch.any(l_port == C - 1)  # a tie with class 0 never picks the later one


@pytest.mark.parametrize("C", [1, 3, 17])
@pytest.mark.parametrize("d", [64, 65, 66, 67])
@pytest.mark.parametrize("B", [1, 8, 260])
def test_dense_predict_every_row_alignment(B, d, C):
    """d of every residue mod 4 (the kernel's rows then start at every
    16-byte phase), one to several hundred rows, up to 17 classes with ties."""
    X, W = _inputs(B, d, C, seed=7)
    Wq = W[0] if C == 1 else W
    s_ref, l_ref = RO.dense_predict(jnp.asarray(Wq), jnp.asarray(X), interpret=True)
    s_port, l_port = TO.dense_predict(torch.from_numpy(Wq), torch.from_numpy(X))
    np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(l_port.numpy(), np.asarray(l_ref))
    if C > 1:
        assert not torch.any(l_port == C - 1)  # tied with class 0: the first wins


@pytest.mark.parametrize("n,parts", [(3299, 132), (8, 132), (1, 132), (0, 16), (5, 16),
                                     (25 * 2079, 16), (2079, 16), (132, 132)])
def test_even_split_covers_each_item_once(n, parts):
    ranges = TP.even_split(n, parts)
    assert len(ranges) == parts and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, no overlap
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    assert sum(sizes) == n


@pytest.mark.parametrize("B,n_sm,want", [(3299, 132, 132), (64, 132, 64), (8, 132, 8),
                                         (1, 132, 1), (0, 132, 1), (132, 132, 132)])
def test_dense_grid_is_one_wave_without_empty_blocks(B, n_sm, want):
    blocks = TP.dense_grid(B, n_sm)
    assert blocks == want
    if B:
        assert all(hi > lo for lo, hi in TP.even_split(B, blocks))


def test_dense_scores_masks_classes_beyond_n_classes():
    X, W = _inputs(6, 50, 4, seed=3)
    W[3] = 100.0 * np.abs(W[3])  # would win every row if it were counted
    S, labels = TP.dense_scores(torch.from_numpy(X), torch.from_numpy(W), n_classes=3)
    assert S.shape == (6, 4)
    np.testing.assert_array_equal(labels.numpy(), np.argmax((X @ W.T)[:, :3], axis=1))


def test_dense_predict_rejects_3d_weights():
    with pytest.raises(ValueError):
        TO.dense_predict(torch.zeros(2, 3, 4), torch.zeros(5, 4))

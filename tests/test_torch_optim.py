"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's ``repro.optim``: every transform and schedule over the same
random trees for a few steps, at 1e-6; and the leading replica axis of
gossip training against the reference's ``jax.vmap``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as R  # noqa: E402
from repro_torch import optim as P  # noqa: E402

ATOL = 1e-6
STEPS = 4


def _tree(rng, lead=()):
    shapes = {"a": {"w": (5, 3), "b": (3,)}, "c": [(4,), (2, 2)], "d": (7,)}

    def draw(s):
        return rng.normal(size=lead + s).astype(np.float32)

    return {"a": {k: draw(s) for k, s in shapes["a"].items()},
            "c": [draw(s) for s in shapes["c"]], "d": draw(shapes["d"])}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return P.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(port_tree, ref_tree, atol=ATOL):
    got, want = P.tree_leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


SCHEDULES = {
    "constant": lambda m: m.constant(0.1),
    "pegasos": lambda m: m.pegasos_schedule(0.05),
    "cosine_warmup": lambda m: m.cosine_warmup(0.3, 3, 10, floor=0.01),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    steps = np.arange(0, 14, dtype=np.int32)
    want = np.asarray(jax.vmap(SCHEDULES[name](R))(jnp.asarray(steps)))
    got = SCHEDULES[name](P)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


TRANSFORMS = {
    "scale": lambda m: m.scale(-0.7),
    "scale_by_schedule": lambda m: m.scale_by_schedule(m.cosine_warmup(0.3, 2, 6)),
    "clip_active": lambda m: m.clip_by_global_norm(0.5),
    "clip_idle": lambda m: m.clip_by_global_norm(1e3),
    "sgd": lambda m: m.sgd(0.05),
    "sgd_momentum": lambda m: m.sgd(m.cosine_warmup(0.1, 2, 6), momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(0.05, momentum=0.9, nesterov=True),
    "adamw": lambda m: m.adamw(m.cosine_warmup(3e-2, 2, 6)),
    "adamw_decay": lambda m: m.adamw(1e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1),
    "chain": lambda m: m.chain(m.clip_by_global_norm(1.0), m.adamw(1e-2, weight_decay=0.01)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_steps_match_reference(name):
    """STEPS updates on fresh random gradients, the updates applied each
    step: updates, state and params at 1e-6."""
    rng = np.random.default_rng(sorted(TRANSFORMS).index(name))
    params = _tree(rng)
    rt, pt = TRANSFORMS[name](R), TRANSFORMS[name](P)
    rp, pp = _jax(params), _torch(params)
    rs, ps = rt.init(rp), pt.init(pp)
    for _ in range(STEPS):
        grads = _tree(rng)
        ru, rs = jax.jit(rt.update)(_jax(grads), rs, rp)
        pu, ps = pt.update(_torch(grads), ps, pp)
        _close(pu, ru)
        rp, pp = R.apply_updates(rp, ru), P.apply_updates(pp, pu)
        _close(pp, rp)
    _close(ps, rs)
    assert type(ps).__name__ == type(rs).__name__


def test_global_norm_and_apply_updates_match_reference():
    rng = np.random.default_rng(1)
    a, b = _tree(rng), _tree(rng)
    np.testing.assert_allclose(float(P.global_norm(_torch(a))),
                               float(R.transforms.global_norm(_jax(a))), rtol=1e-6)
    _close(P.apply_updates(_torch(a), _torch(b)), R.apply_updates(_jax(a), _jax(b)))


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw"])
def test_replica_axis_matches_vmapped_reference(name):
    """Gossip training's layout: every leaf and counter with a leading
    replica axis of 3, clipped per replica: the reference vmaps the clip and
    the update over it."""
    G = 3
    rng = np.random.default_rng(2)
    params = _tree(rng, (G,))
    rt, pt = TRANSFORMS[name](R), TRANSFORMS[name](P)
    rp, pp = _jax(params), _torch(params)
    rs = jax.vmap(rt.init)(rp)
    one = pt.init(P.tree_map(lambda x: x[0], pp))
    ps = P.tree_map(lambda x: x.expand((G,) + x.shape).clone(), one)
    rclip, pclip = R.clip_by_global_norm(0.8), P.clip_by_global_norm(0.8, lead=1)
    for _ in range(STEPS):
        grads = _tree(rng, (G,))
        rg = jax.vmap(lambda g: rclip.update(g, (), None)[0])(_jax(grads))
        pg, _ = pclip.update(_torch(grads), (), None)
        _close(pg, rg)
        ru, rs = jax.vmap(rt.update)(rg, rs, rp)
        pu, ps = pt.update(pg, ps, pp)
        rp, pp = R.apply_updates(rp, ru), P.apply_updates(pp, pu)
        _close(pp, rp)
    _close(ps, rs)

"""The port's MoE channel mixing (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the reference's params: the output at
1e-5, the aux losses and expert fractions at 1e-6, the routing (top-k
experts, capacity, kept choices) equal, with and without a shared expert,
with overflow forced by a small ``capacity_factor``, at one token (decode),
and through the port's ``Model``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.config import MoEConfig as RMoEConfig  # noqa: E402
from repro_torch.convert import load_params  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

Y_ATOL, AUX_ATOL = 1e-5, 1e-6
D = 32

CASES = {  # n_experts, top_k, d_expert, d_shared, capacity_factor, mlp
    "qwen_like": (6, 3, 24, 40, 1.25, "gated_silu"),
    "mixtral_like": (4, 2, 48, 0, 1.25, "gated_silu"),
    "overflow": (4, 2, 24, 0, 0.3, "gated_silu"),
    "overflow_shared_gelu": (5, 2, 16, 24, 0.5, "gelu"),
}


def _setup(case, seed=0):
    e, k, f, shared, cf, mlp = CASES[case]
    kw = dict(n_experts=e, top_k=k, d_expert=f, d_shared=shared, capacity_factor=cf)
    rcfg, pcfg = RMoEConfig(**kw), MoEConfig(**kw)
    params = RM.init_moe(jax.random.PRNGKey(seed), D, rcfg, mlp)
    port = load_params(PM.MoE(D, pcfg, mlp, device="cpu"), jax.tree.map(np.asarray, params))
    return rcfg, pcfg, mlp, params, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_routing(params, x, cfg, cap):
    """The reference's routing, row by row, as its ``_group_moe`` computes it."""
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", x, params["router"]), axis=-1)
    _, topi = jax.lax.top_k(probs, cfg.top_k)
    topi = np.asarray(topi)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[topi]
    b, s, k, e = onehot.shape
    flat = onehot.reshape(b, s * k, e)
    pos = ((np.cumsum(flat, axis=1) - flat).reshape(b, s, k, e) * onehot).sum(-1)
    return topi, pos, pos < cap


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("S", [1, 24])
def test_moe_apply_matches_reference(case, S):
    rcfg, pcfg, mlp, params, port = _setup(case)
    x = _x((3, S, D))
    y, aux = jax.jit(lambda p, x: RM.moe_apply(p, x, rcfg, mlp))(params, jnp.asarray(x))
    got, paux = PM.moe_apply(port, torch.from_numpy(x), pcfg, mlp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=Y_ATOL)
    for name in ("load_balance_loss", "router_z_loss", "expert_fraction"):
        np.testing.assert_allclose(getattr(paux, name).detach().numpy(),
                                   np.asarray(getattr(aux, name)), rtol=0, atol=AUX_ATOL)

    cap = PM.capacity(S, pcfg)
    assert cap == RM.capacity(S, rcfg)
    topi, pos, keep = _ref_routing(params, jnp.asarray(x), rcfg, cap)
    r = PM.route(port.router, torch.from_numpy(x), pcfg, cap)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if S == 1:
        assert cap == pcfg.top_k and keep.all()  # decode: every choice fits
    if case.startswith("overflow") and S > 1:
        assert not keep.all()  # the capacity factor drops choices


def test_moe_gradients_match_reference():
    """Gradients of a scalar of the output and the aux losses with respect to
    every MoE parameter, with overflow, against ``jax.grad``."""
    rcfg, pcfg, mlp, params, port = _setup("overflow_shared_gelu", seed=3)
    x = _x((2, 16, D), seed=4)

    def ref_obj(p):
        y, aux = RM.moe_apply(p, jnp.asarray(x), rcfg, mlp)
        return jnp.sum(jnp.sin(y)) + aux.load_balance_loss + aux.router_z_loss

    want = jax.tree.map(np.asarray, jax.jit(jax.grad(ref_obj))(params))
    y, aux = PM.moe_apply(port, torch.from_numpy(x), pcfg, mlp)
    (torch.sum(torch.sin(y)) + aux.load_balance_loss + aux.router_z_loss).backward()
    for name, p in port.named_parameters():
        node = want
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(p.grad.numpy(), node, rtol=0, atol=Y_ATOL, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
def test_reduced_moe_configs_route_like_the_reference(arch):
    """The reduced MoE configs' own MoEConfig (shared expert for qwen2-moe,
    none for mixtral), at capacity 1.0 to force overflow."""
    cfg = ref_config(arch).reduced(n_layers=2, d_model=64)
    rcfg = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    pcfg = MoEConfig(**dataclasses.asdict(rcfg))
    params = RM.init_moe(jax.random.PRNGKey(5), 64, rcfg, cfg.mlp)
    port = load_params(PM.MoE(64, pcfg, cfg.mlp, device="cpu"), jax.tree.map(np.asarray, params))
    x = _x((2, 40, 64), seed=6)
    y, aux = jax.jit(lambda p, x: RM.moe_apply(p, x, rcfg, cfg.mlp))(params, jnp.asarray(x))
    got, paux = PM.moe_apply(port, torch.from_numpy(x), pcfg, cfg.mlp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=Y_ATOL)
    np.testing.assert_allclose(float(paux.load_balance_loss.detach()), float(aux.load_balance_loss),
                               rtol=0, atol=AUX_ATOL)

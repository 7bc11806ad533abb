"""B10-B12 as registered operators (``torch.ops.repro_torch.*``): their
forward on the CPU against the reference's oracles on the same numpy
inputs, ``torch.library.opcheck`` of each operator and each backward
operator, a reduced model's forward and backward traced under
``FakeTensorMode`` without a launch or a plain version, the FLOP formulas
against hand counts, and the dry-run's local-FLOP rule on a sharded and a
replicated product."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.library import opcheck  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.rglru_scan.ref import scan_ref as ref_rglru  # noqa: E402
from repro.kernels.rwkv6_scan.ref import scan_ref as ref_wkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan as RG  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as WK  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.input_specs import train_batch_shapes  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_host_mesh  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ATOL = 1e-5
OPS = torch.ops.repro_torch


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"q": f(2, 9, 4, 8), "k": f(2, 9, 2, 8), "v": f(2, 9, 2, 8),
            "a": (0.5 + 0.4 * rng.random((2, 7, 5))).astype(np.float32), "b": f(2, 7, 5),
            "r": f(2, 6, 3, 4, scale=0.3), "kk": f(2, 6, 3, 4, scale=0.3),
            "vv": f(2, 6, 3, 4, scale=0.3), "w": (0.5 + 0.4 * rng.random((2, 6, 3, 4))).astype(np.float32),
            "u": f(3, 4, scale=0.1), "d_attn": f(2, 9, 4, 8), "d_wkv": f(2, 6, 3, 4)}


def _t(x, grad=False):
    return torch.from_numpy(x).requires_grad_(grad)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_flash_attention_op_matches_reference(causal, window):
    x = _inputs()
    got = FA.flash_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]), causal=causal, window=window)
    # the reference's oracle on (BH, S, dh) planes, kv heads repeated for the groups
    q = np.moveaxis(x["q"], 2, 1).reshape(8, 9, 8)
    kv = [np.repeat(np.moveaxis(x[n], 2, 1), 2, axis=1).reshape(8, 9, 8) for n in "kv"]
    want = np.asarray(attention_ref(jnp.asarray(q), *map(jnp.asarray, kv), causal=causal,
                                    window=window))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want.reshape(2, 4, 9, 8), 1, 2),
                               rtol=0, atol=ATOL)


def test_scan_ops_match_reference():
    x = _inputs()
    np.testing.assert_allclose(RG.rglru_scan(_t(x["a"]), _t(x["b"])).numpy(),
                               np.asarray(ref_rglru(jnp.asarray(x["a"]), jnp.asarray(x["b"]))),
                               rtol=0, atol=ATOL)
    args = [x[n] for n in ("r", "kk", "vv", "w", "u")]
    np.testing.assert_allclose(WK.wkv_scan(*map(_t, args)).numpy(),
                               np.asarray(ref_wkv(*map(jnp.asarray, args))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("op", ["flash_attention", "flash_attention_backward", "rglru_scan",
                                "wkv_scan", "wkv_scan_backward"])
def test_opcheck(op):
    x = _inputs()
    args = {"flash_attention": lambda: (_t(x["q"], True), _t(x["k"], True), _t(x["v"], True),
                                        True, 3),
            "flash_attention_backward": lambda: (_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                                 _t(x["d_attn"]), True, 3),
            "rglru_scan": lambda: (_t(x["a"], True), _t(x["b"], True)),
            "wkv_scan": lambda: tuple(_t(x[n], True) for n in ("r", "kk", "vv", "w", "u")),
            "wkv_scan_backward": lambda: tuple(_t(x[n]) for n in ("r", "kk", "vv", "w", "u",
                                                                 "d_wkv"))}[op]()
    opcheck(getattr(OPS, op), args)


@pytest.mark.parametrize("arch,layers", [("llama3-8b", 2), ("recurrentgemma-9b", 3),
                                         ("rwkv6-3b", 2)])
def test_model_traces_under_fake_tensors_without_launch_or_plain(monkeypatch, arch, layers):
    """Fake CPU tensors (this PyTorch has no CUDA; autograd over fake CUDA
    tensors needs a CUDA build): the operators' fake implementations give
    the shapes, and no plain version runs."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran under FakeTensorMode")

    for mod, name in ((FA, "flash_attention_plain"), (RG, "rglru_scan_plain"),
                      (WK, "wkv_scan_plain")):
        monkeypatch.setattr(mod, name, boom)
    counts = (FA.flash_attention.launches, RG.rglru_scan.launches, WK.wkv_scan.launches,
              FA.flash_attention.plain_backwards, WK.wkv_scan.plain_backwards)
    cfg = get_config(arch).reduced(n_layers=layers, d_model=64)
    with FakeTensorMode():
        model = Model(cfg, device="cpu")
        batch = train_batch_shapes(cfg, InputShape("t", 16, 2, "train"), act_dtype=torch.float32,
                                   device="cpu")
        batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        logits, _ = model.forward(batch)
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        loss, _ = model.loss(batch)
        loss.backward()
        for name, p in model.named_parameters():
            assert p.grad is not None and p.grad.shape == p.shape, name
    assert counts == (FA.flash_attention.launches, RG.rglru_scan.launches, WK.wkv_scan.launches,
                      FA.flash_attention.plain_backwards, WK.wkv_scan.plain_backwards)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("s,causal,window", [(9, True, 0), (9, True, 3), (9, False, 0),
                                             (9, False, 4), (5, True, 64)])
def test_flash_attention_flop_formula_counts_live_pairs(s, causal, window):
    q, k, v = torch.zeros(2, s, 4, 8), torch.zeros(2, s, 2, 8), torch.zeros(2, s, 2, 8)
    live = int(FA.band_mask(s, s, causal=causal, window=window).sum())
    assert FA.live_pairs(s, causal=causal, window=window) == live
    assert _flops(lambda: OPS.flash_attention(q, k, v, causal, window)) == 4 * 8 * 4 * 2 * live
    d = torch.zeros(2, s, 4, 8)
    assert _flops(lambda: OPS.flash_attention_backward(q, k, v, d, causal, window)) == (
        5 * (4 * 8 * 4 * 2 * live) // 2)


def test_scan_flop_formulas():
    a = torch.full((2, 7, 5), 0.5)
    assert _flops(lambda: OPS.rglru_scan(a, a)) == 2 * 2 * 7 * 5
    r, u = torch.zeros(2, 6, 3, 4), torch.zeros(3, 4)
    per = 2 * 6 * 3 * (5 * 4 * 4 + 5 * 4)
    assert _flops(lambda: OPS.wkv_scan(r, r, r, r, u)) == per
    assert _flops(lambda: OPS.wkv_scan_backward(r, r, r, r, u, r)) == 2 * per


def test_local_flop_rule_counts_each_ranks_share():
    """A product replicated on every rank counts in full on rank 0; one
    sharded over the 4 ranks of a (2, 2) mesh counts a quarter."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m, k, n = 64, 32, 16
    with fake_world(4):
        mesh = make_host_mesh(2, 2, device_type="cpu")
        with FakeTensorMode():
            def dt(local, pl, shape):
                return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                                          stride=torch.empty(shape, device="meta").stride())

            rep = (Replicate(), Replicate())
            a, b = dt(torch.empty(m, k), rep, (m, k)), dt(torch.empty(k, n), rep, (k, n))
            with dryrun.StepCounter(dryrun.CollectiveRecorder()) as full:
                torch.mm(a, b)
            rows = dt(torch.empty(m // 4, k), (Shard(0), Shard(0)), (m, k))
            with dryrun.StepCounter(dryrun.CollectiveRecorder()) as part:
                out = torch.mm(rows, b)
            assert tuple(out.to_local().shape) == (m // 4, n)
    assert full.flops == 2 * m * k * n
    assert part.flops == 2 * m * k * n // 4

"""The port's transformer training (``repro_torch.launch.steps``, ``optim``,
``launch.train``) against the reference: ``make_train_step`` in all-reduce
mode for 3 fixed steps (not under a stop rule) on every family from the
same state and batches, parameters and optimizer moments held as the
note above ``OUTLIER_SHARE`` says; remat against no remat within the port, bit
for bit; the reference's ``test_train_integration.py`` properties in the
port; train-state checkpoints across the two packages both ways; and the
CLI. The gossip-mode steps are in ``test_torch_train_gossip.py``, which
shares ``run_pair`` and ``assert_states_close`` from here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.optim import transforms as ref_transforms  # noqa: E402
from repro_torch import checkpoint as port_ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_to_reference, train_state_to_torch  # noqa: E402
from repro_torch.data.tokens import Batcher, TokenStreamConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.input_specs import make_host_batch  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

STEPS, BATCH, SEQ, G = 3, 8, 16, 4
ATOL = 1e-5
# Two mechanisms turn the ~1e-6 relative rounding between XLA's and
# PyTorch's sums into larger differences on a few elements, so there the
# parameters are held at ATOL on all but OUTLIER_SHARE of the elements and
# every element within a bound of its own:
# * AdamW divides each element's step by its own root-mean-square gradient:
#   an element whose gradient is near zero takes a different step of up to
#   lr (a few elements in 1e5 at lr 3e-3, up to 9.4e-5): ADAMW_LR_SHARE · lr;
# * the bf16 gossip payload rounds each sent share to bf16: a value on a
#   rounding boundary rounds the other way, a difference of (1 − s) bf16
#   ulps of it: 2^-9 of the leaf's largest magnitude at s = 1/2.
# The moments, and the parameters under SGD with the full payload, at ATOL.
OUTLIER_SHARE = 1e-4
ADAMW_LR_SHARE = 0.1
BF16_HALF_ULP = 2.0 ** -9


def trainer(consensus="allreduce", optimizer="adamw", **kw):
    kw = dict(dict(lr=3e-3, warmup_steps=2, total_steps=10), **kw)
    return dict(optimizer=optimizer, consensus=consensus,
                n_replicas=G if consensus == "gossip" else 1, **kw)


def as_reference(tree):
    """A numpy train state with the port's optimizer NamedTuples as the
    reference's classes of the same names, as JAX arrays."""
    if isinstance(tree, dict):
        return {k: as_reference(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return getattr(ref_transforms, type(tree).__name__)(*map(as_reference, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_reference(v) for v in tree)
    return jnp.asarray(tree)


def run_pair(arch, n_layers=2, d_model=64, **tkw):
    """(the reference's state, the port's state, the port's tcfg, its cfg,
    the per-step losses of both) after STEPS steps from the same state (the
    port's initial state carried to the reference: its own init compiles
    op by op, seconds a config)."""
    cfg = ref_config(arch).reduced(n_layers=n_layers, d_model=d_model)
    pcfg = get_config(arch).reduced(n_layers=n_layers, d_model=d_model)
    rt, pt = ref_steps.TrainerConfig(**tkw), steps.TrainerConfig(**tkw)
    model = Model(pcfg, device="cpu")
    pstate = steps.make_train_state(model, pt, torch.Generator().manual_seed(0))
    state = as_reference(train_state_to_reference(pcfg, pt, pstate))
    rstep = jax.jit(ref_steps.make_train_step(RefModel(cfg), rt))
    pstep = steps.make_train_step(model, pt)
    losses = []
    for s in range(STEPS):
        b = make_host_batch(pcfg, BATCH, SEQ, seed=100 + s,
                            n_replicas=G if pt.consensus == "gossip" else 0, device="cpu")
        state, m = rstep(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        pstate, pm = pstep(pstate, b)
        losses.append((float(m["loss"]), float(pm["loss"])))
        assert set(pm) == {"loss", "ce", "aux"}
    want = train_state_to_torch(pcfg, pt, jax.tree.map(np.asarray, state), device="cpu")
    return want, pstate, pt, pcfg, losses


def assert_states_close(want, got, tcfg):
    assert int(got["step"]) == int(want["step"]) == STEPS
    params_w, params_g = want["params"], got["params"]
    assert set(params_g) == set(params_w)
    if tcfg.optimizer == "adamw":
        moments = [(want["opt"].mu, got["opt"].mu), (want["opt"].nu, got["opt"].nu)]
        np.testing.assert_array_equal(got["opt"].step.numpy(), want["opt"].step.numpy())
    else:
        moments = [(want["opt"][0].momentum, got["opt"][0].momentum)]
        np.testing.assert_array_equal(got["opt"][1].step.numpy(), want["opt"][1].step.numpy())
    for w_tree, g_tree in moments:
        for k in params_w:
            np.testing.assert_allclose(g_tree[k].numpy(), w_tree[k].numpy(), rtol=0, atol=ATOL,
                                       err_msg=k)
    total = outliers = 0
    for k in params_w:
        diff = (params_g[k] - params_w[k]).abs()
        bound = ATOL
        if tcfg.optimizer == "adamw":
            bound = max(bound, ADAMW_LR_SHARE * tcfg.lr)
        if tcfg.gossip_payload == "bf16":
            bound += BF16_HALF_ULP * float(params_w[k].abs().max())
        assert float(diff.max()) <= bound, (k, float(diff.max()), bound)
        total += diff.numel()
        outliers += int((diff > ATOL).sum())
    if tcfg.optimizer == "sgd" and tcfg.gossip_payload == "full":
        assert outliers == 0, outliers
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)

CASES = [  # arch, layers, optimizer
    ("llama3-8b", 2, "adamw"),
    ("qwen2-moe-a2.7b", 2, "adamw"),
    ("mixtral-8x22b", 2, "sgd"),          # sliding-window attention, MoE without shared
    ("recurrentgemma-9b", 3, "adamw"),    # one RG-LRU cycle
    ("rwkv6-3b", 2, "sgd"),
    ("llava-next-mistral-7b", 2, "sgd"),  # patches
    ("hubert-xlarge", 2, "adamw"),        # frames, masked cross entropy, encoder
]


@pytest.mark.parametrize("arch,n_layers,optimizer", CASES)
def test_allreduce_step_matches_reference(arch, n_layers, optimizer):
    want, got, tcfg, _, losses = run_pair(arch, n_layers, **trainer("allreduce", optimizer))
    for ref_loss, port_loss in losses:
        assert abs(ref_loss - port_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    assert_states_close(want, got, tcfg)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_equals_no_remat_bit_for_bit(policy):
    """Per-block checkpointing recomputes the same arithmetic: the states
    after two steps equal bit for bit (qwen2-moe: attention and MoE)."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(n_layers=2, d_model=64)
    model = Model(cfg, device="cpu")
    states = []
    for remat in (False, True):
        tcfg = steps.TrainerConfig(**trainer("allreduce", "adamw", remat=remat,
                                             remat_policy=policy))
        state = steps.make_train_state(model, tcfg, torch.Generator().manual_seed(0))
        step = steps.make_train_step(model, tcfg)
        for s in range(2):
            state, _ = step(state, make_host_batch(cfg, 4, 12, seed=s, device="cpu"))
        states.append(state)
    for k, v in states[0]["params"].items():
        assert torch.equal(v, states[1]["params"][k]), k
    for k, v in states[0]["opt"].mu.items():
        assert torch.equal(v, states[1]["opt"].mu[k]), k


def _run(consensus="allreduce", n_replicas=4, steps_=15, gossip_rounds=1, batch=8, seq=32):
    """The reference's ``test_train_integration._run`` in the port."""
    cfg = get_config("llama3-8b").reduced(n_layers=2, d_model=128)
    model = Model(cfg, device="cpu")
    tcfg = steps.TrainerConfig(optimizer="adamw", lr=3e-3, total_steps=steps_, warmup_steps=2,
                               consensus=consensus,
                               n_replicas=n_replicas if consensus == "gossip" else 1,
                               gossip_rounds=gossip_rounds)
    state = steps.make_train_state(model, tcfg, torch.Generator().manual_seed(0))
    step_fn = steps.make_train_step(model, tcfg)
    batcher = Batcher(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=0))
    losses = []
    for s in range(steps_):
        b = {k: torch.from_numpy(v) for k, v in batcher.global_batch(s).items()}
        if consensus == "gossip":
            b = {k: v.reshape(n_replicas, batch // n_replicas, seq) for k, v in b.items()}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("consensus", ["allreduce", "gossip"])
def test_loss_improves(consensus):
    _, losses = _run(consensus=consensus)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2


def test_gossip_replicas_reach_consensus():
    state, _ = _run(consensus="gossip", gossip_rounds=2)
    worst = 0.0
    for leaf in state["params"].values():
        center = leaf.mean(dim=0, keepdim=True)
        worst = max(worst, float(torch.linalg.norm(leaf - center))
                    / (float(torch.linalg.norm(center)) + 1e-9))
    assert worst < 0.15, worst


def test_gossip_exact_averaging_keeps_replicas_identical():
    """rounds = log2(G) averages exactly: with the same batch on every
    replica, the replicas stay equal (within 1e-5), as all-reduce's single
    copy would."""
    cfg = get_config("llama3-8b").reduced(n_layers=2, d_model=64)
    model = Model(cfg, device="cpu")
    G = 4
    tcfg = steps.TrainerConfig(optimizer="sgd", lr=1e-2, consensus="gossip", n_replicas=G,
                               gossip_rounds=2)
    state = steps.make_train_state(model, tcfg, torch.Generator().manual_seed(0))
    step_fn = steps.make_train_step(model, tcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    b = {"tokens": toks.expand(G, 2, 16), "targets": toks.expand(G, 2, 16)}
    for _ in range(3):
        state, _ = step_fn(state, b)
    for leaf in state["params"].values():
        assert float((leaf - leaf[:1]).abs().max()) < 1e-5


@pytest.mark.parametrize("consensus,optimizer", [("gossip", "adamw"), ("allreduce", "sgd")])
def test_train_state_checkpoints_cross_load(tmp_path, consensus, optimizer):
    """A train state saved by the port restores with ``repro.checkpoint.restore``
    into the structure of the reference's own state (its treedef, shapes and
    dtypes, from ``jax.eval_shape``), and one saved by the reference restores
    with the port's, leaf for leaf."""
    arch = "qwen2-moe-a2.7b"
    tkw = trainer(consensus, optimizer)
    cfg, pcfg = ref_config(arch).reduced(n_layers=2, d_model=64), get_config(arch).reduced(
        n_layers=2, d_model=64)
    rt, pt = ref_steps.TrainerConfig(**tkw), steps.TrainerConfig(**tkw)
    like = jax.eval_shape(lambda k: ref_steps.make_train_state(RefModel(cfg), rt, k),
                          jax.random.PRNGKey(1))
    pstate = steps.make_train_state(Model(pcfg, device="cpu"), pt,
                                    torch.Generator().manual_seed(2))
    saved = train_state_to_reference(pcfg, pt, pstate)
    port_ckpt.save(str(tmp_path / "port"), 3, saved)
    got = ref_ckpt.restore(str(tmp_path / "port"), like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    back = train_state_to_torch(pcfg, pt, got, "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(pstate)):
        assert torch.equal(a, b)

    ref_ckpt.save(str(tmp_path / "ref"), 3, as_reference(saved))
    again = port_ckpt.restore(str(tmp_path / "ref"), saved)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(saved)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,consensus", [("llama3-8b", "allreduce"),
                                            ("hubert-xlarge", "gossip")])
def test_train_main_on_cpu(tmp_path, capsys, arch, consensus):
    argv = ["--arch", arch, "--steps", "12", "--batch", "8", "--seq", "32", "--d-model", "64",
            "--consensus", consensus, "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--log-jsonl", str(tmp_path / "log.jsonl")]
    assert port_train.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "(improved)" in out
    assert port_ckpt.latest_step(str(tmp_path)) == 12
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 12


def test_train_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--steps", "1"])

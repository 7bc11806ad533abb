"""The port's own draws against the JAX reference's, on the CPU.

``repro_torch.core.counter_rng`` computes ``jax.random``'s Threefry-2x32
streams in int64 tensor ops, so the port's default draws
(``GeneratorDraws``, ``faults.keyed_fail_masks``) are the reference's own
minibatch ids, random-topology rounds and failure masks bit for bit, and a
run with no recorded draws trains as the reference's run of the same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax._src import prng as jprng  # noqa: E402
from repro.core import faults as rflt  # noqa: E402
from repro.core import gadget as G  # noqa: E402
from repro_torch.core import counter_rng as crng  # noqa: E402
from repro_torch.core import faults as tflt  # noqa: E402
from repro_torch.core import gadget as TG  # noqa: E402
from tests.test_torch_faults import N_COUNTS, _assert_faulted_match, _cfgs, _data  # noqa: E402

M32 = 2 ** 32 - 1
SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1, -5]
# Random123's known answers for Threefry-2x32 (20 rounds): key, counter, output
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((M32, M32), (M32, M32), (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("key,count,want", KAT)
def test_threefry_known_answers(key, count, want):
    assert crng.threefry2x32(*key, *count) == want
    got = crng.threefry2x32(*(torch.tensor([v]) for v in key + count))
    assert tuple(int(w[0]) for w in got) == want
    ref = jprng.threefry_2x32(np.uint32(key), np.uint32(count))
    assert _key(ref) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert crng.prng_key(seed) == _key(key)
    ours = crng.prng_key(seed)
    for data in (0, 1, 5, 4000, M32):
        assert crng.fold_in(ours, data) == _key(jax.random.fold_in(key, data))
    split = np.asarray(jax.random.split(key, 6))
    got = crng.fold_in(ours, torch.arange(6))
    assert np.array_equal(np.stack([g.numpy() for g in got], axis=1), split.astype(np.int64))
    bits = np.asarray(jax.random.bits(key, (3, 5))).astype(np.int64)
    assert np.array_equal(crng.random_bits(ours, torch.arange(15)).view(3, 5).numpy(), bits)


def test_prng_key_refuses_seeds_past_32_bits():
    for seed in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(ValueError):
            crng.prng_key(seed)


@pytest.mark.parametrize("span", [0, 1, 2, 9, 7812, 65535, 65536, 65537, 100_000, 2 ** 31 - 1])
def test_randint_matches_jax(span):
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (64,), 0, span))
        got = crng.randint(crng.prng_key(seed), torch.arange(64), span)
        assert np.array_equal(got.numpy(), want), (seed, span)


@pytest.mark.parametrize("p", [0.0, 1e-8, 0.1, 0.3, 0.5, 0.999])
def test_bernoulli_matches_jax(p):
    for seed in (0, 11):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (9, 9)))
        got = crng.bernoulli(crng.prng_key(seed), torch.arange(81), p).view(9, 9)
        assert np.array_equal(got.numpy(), want), (seed, p)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("seed", [0, 5])
def test_generator_draws_are_the_reference_draws(fused, seed):
    """Ids (over counts on both sides of 2^16) and random-topology mixing of
    iterations 1-30, drawn whole and in two chunks."""
    m, B, R, T = 10, 3, 4, 30
    counts = np.array([7812, 5, 100, 70000, 3, 9, 65537, 12, 2, 1], np.int32)
    data_key, mix_key = G._stream_keys(seed)
    ts = jnp.arange(1, T + 1, dtype=jnp.int32)
    ids = np.asarray(jax.vmap(lambda t: G._batch_ids(data_key, t, jnp.asarray(counts), B))(ts))
    mix = np.asarray(jax.vmap(lambda t: G._iter_mixing(mix_key, None, t, m, R, "random",
                                                       fused))(ts))
    plan = TG.DrawPlan(m, B, R, "random", fused, torch.from_numpy(counts.astype(np.int64)))
    draws = TG.GeneratorDraws(seed)
    got_ids, got_mix = draws.take(1, T, plan)
    assert np.array_equal(got_ids.numpy(), ids)
    if fused:  # the reference folds the rounds in its own order
        np.testing.assert_allclose(got_mix.numpy(), mix, rtol=0, atol=1e-6)
    else:
        assert np.array_equal(got_mix.numpy(), mix)
    late_ids, late_mix = draws.take(12, T - 11, plan)
    assert torch.equal(late_ids, got_ids[11:]) and torch.equal(late_mix, got_mix[11:])


@pytest.mark.parametrize("p,seed", [(0.1, 0), (0.35, 4)])
def test_fail_masks_are_the_reference_masks(p, seed):
    m, R, T = 6, 3, 25
    plan = rflt.validate_plan(rflt.FaultPlan(drop_prob=p, seed=seed), m)

    def one(t, r):
        return jax.random.bernoulli(rflt.round_fail_key(plan, t, r), plan.drop_prob, (m, m))

    ts, rs = jnp.arange(1, T + 1), jnp.arange(R)
    want = np.asarray(jax.vmap(lambda t: jax.vmap(lambda r: one(t, r))(rs))(ts))
    got = tflt.keyed_fail_masks(tflt.FaultPlan(drop_prob=p, seed=seed), 1, T, R, m)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("topology,fused,plan", [
    ("random", True, None),
    ("random", False, None),
    ("ring", True, tflt.FaultPlan(drop_prob=0.3, drop="link", seed=2)),
    ("random", True, tflt.FaultPlan(drop_prob=0.2, drop="message", dead_nodes=(1,), seed=5)),
], ids=["random-fused", "random-unfused", "ring-link", "random-message-dead"])
def test_own_draws_train_as_the_reference(topology, fused, plan):
    """No recorded draws: the port's default run is the reference's run of
    the same seed, at the parity tests' 1e-5."""
    X, y = _data(seed=8)
    rcfg, tcfg = _cfgs(topology, fused, plan)
    ref = G.gadget_train(X, y, rcfg, n_counts=N_COUNTS)
    port = TG.gadget_train(X, y, tcfg, n_counts=N_COUNTS, device="cpu")
    _assert_faulted_match(ref, port)

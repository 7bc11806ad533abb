"""The port's synthetic token stream (``repro_torch.data.tokens``) against
the reference's ``repro.data.tokens``: the stream, the global batch, the
host-local slices and the iterator, bit for bit."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import tokens as R  # noqa: E402
from repro_torch.data import tokens as P  # noqa: E402

CONFIGS = [dict(vocab_size=512, seq_len=32, global_batch=8, seed=0),
           dict(vocab_size=151936, seq_len=100, global_batch=4, seed=7, zipf_a=1.05,
                motif_len=5, motif_prob=0.5),
           dict(vocab_size=32, seq_len=3, global_batch=2, seed=3, motif_len=8)]


@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "wide_vocab", "short_seq"])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_stream_is_the_reference_bit_for_bit(kw, step):
    want = R.synthetic_tokens(R.TokenStreamConfig(**kw), step)
    got = P.synthetic_tokens(P.TokenStreamConfig(**kw), step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_batches_and_local_slices_are_the_reference(n_hosts):
    kw = CONFIGS[0]
    rb, pb = R.Batcher(R.TokenStreamConfig(**kw)), P.Batcher(P.TokenStreamConfig(**kw))
    for step in (0, 3):
        want, got = rb.global_batch(step), pb.global_batch(step)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["targets"][:, :-1])
        for host in range(n_hosts):
            w, g = rb.local_slice(step, host, n_hosts), pb.local_slice(step, host, n_hosts)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_iterator_and_errors_are_the_reference():
    kw = CONFIGS[0]
    rb, pb = R.Batcher(R.TokenStreamConfig(**kw)), P.Batcher(P.TokenStreamConfig(**kw))
    for w, g in zip(itertools.islice(rb, 3), itertools.islice(pb, 3)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    with pytest.raises(ValueError, match="not divisible by 3 hosts"):
        pb.local_slice(0, 0, 3)


@pytest.mark.parametrize("arch", ["llama3-8b", "llava-next-mistral-7b", "hubert-xlarge"])
@pytest.mark.parametrize("n_replicas", [0, 4])
def test_host_batches_match_reference(arch, n_replicas):
    """``launch.input_specs.make_host_batch`` in the three layouts, with and
    without the replica axis: the token, target and mask draws are the
    reference's Threefry streams bit for bit; the embeddings' normal draws
    share its uniform bits and differ in the inverse error function's last
    bits (within 1e-6)."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.launch.input_specs import make_host_batch as ref_batch
    from repro_torch.configs import get_config
    from repro_torch.launch.input_specs import make_host_batch

    want = ref_batch(ref_config(arch).reduced(), 8, 32, key=jax.random.PRNGKey(1003),
                     n_replicas=n_replicas)
    got = make_host_batch(get_config(arch).reduced(), 8, 32, seed=1003, n_replicas=n_replicas,
                          device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ("patch_embeds", "frames"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)

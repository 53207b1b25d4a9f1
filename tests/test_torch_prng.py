"""The port's threefry copy (repro_torch.prng) against jax.random, and the
serving sampler built on it against the JAX sampler: exact equality.

JAX's draws depend on ``jax_threefry_partitionable``; the port implements
the partitionable mode, so the flag is asserted first.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve.sampling import sample_tokens as jax_sample  # noqa: E402
from repro.serve.sampling import slot_keys as jax_slot_keys  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.serve.sampling import sample_tokens, slot_keys  # noqa: E402

SEEDS = [0, 1234567, 2 ** 32 - 3]


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable, \
        "repro_torch.prng implements the partitionable threefry mode"


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_exact(seed):
    k, t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(k), t.numpy())
    for d in (0, 5, 0x5151, 2 ** 31 + 7):
        np.testing.assert_array_equal(_np(jax.random.fold_in(k, d)),
                                      prng.fold_in(t, d).numpy())
    # -1 as an int32 array folds in as 0xFFFFFFFF (inactive serving slots)
    np.testing.assert_array_equal(
        _np(jax.random.fold_in(k, jnp.int32(-1))), prng.fold_in(t, -1).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(k, 7)),
                                  prng.split(t, 7).numpy())


@pytest.mark.parametrize("shape", [(3, 7), (1000,), (2, 3, 5)])
def test_bits_and_uniform_exact(shape):
    k, t = jax.random.PRNGKey(42), prng.PRNGKey(42)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64),
        prng.bits(t, shape).numpy())
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, shape, minval=tiny)),
        prng.uniform(t, shape, tiny).numpy())


def test_batched_keys_and_categorical_exact():
    base_j, base_t = jax.random.PRNGKey(3), prng.PRNGKey(3)
    rids = np.array([0, 4, -1, 9], np.int32)
    counts = np.array([0, 2, 7, 31], np.int32)
    kj = jax_slot_keys(base_j, jnp.asarray(rids), jnp.asarray(counts))
    kt = slot_keys(base_t, torch.from_numpy(rids).long(),
                   torch.from_numpy(counts).long())
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    logits = np.random.RandomState(0).randn(4, 509).astype(np.float32) * 2
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.categorical)(kj, logits)),
        prng.categorical(kt, torch.from_numpy(logits)).numpy())
    # gumbel noise agrees to float32 round-off (log is not bit-specified)
    np.testing.assert_allclose(
        np.asarray(jax.random.gumbel(base_j, (4096,))),
        prng.gumbel(base_t, (4096,)).numpy(), rtol=0, atol=1e-6)


def test_sample_tokens_matches_jax():
    """Greedy, temperature, top-k, top-p and padded-vocab masking pick the
    same token ids as the JAX sampler for the same logits and keys."""
    rng = np.random.RandomState(1)
    temp = np.array([0.8, 0.0, 1.3, 0.5, 1.0], np.float32)
    topk = np.array([20, 0, 0, 5, 1], np.int32)
    topp = np.array([0.0, 0.0, 0.9, 0.0, 0.5], np.float32)
    for _ in range(20):
        logits = (rng.randn(5, 512) * 3).astype(np.float32)
        rids = rng.randint(-1, 50, 5).astype(np.int32)
        counts = rng.randint(0, 30, 5).astype(np.int32)
        want = jax_sample(
            jnp.asarray(logits),
            jax_slot_keys(jax.random.PRNGKey(0), jnp.asarray(rids),
                          jnp.asarray(counts)),
            jnp.asarray(temp), jnp.asarray(topk), 509, jnp.asarray(topp))
        got = sample_tokens(
            torch.from_numpy(logits),
            slot_keys(prng.PRNGKey(0), torch.from_numpy(rids).long(),
                      torch.from_numpy(counts).long()),
            torch.from_numpy(temp), torch.from_numpy(topk).long(), 509,
            torch.from_numpy(topp))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert got.max() < 509

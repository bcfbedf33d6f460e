"""ops/prng.py against jax.random, bit for bit: key, fold_in, key_data,
split, random bits and randint(key, (n,), lo, hi, int32), over a few
hundred seeds and data values, crc32-sized ones included. The JAX side
runs with its defaults (jax_threefry_partitionable on)."""

import zlib

import numpy as np
import pytest

from paddle_tpu_torch.ops import prng

SEEDS = [0, 1, 7, 42, 1234, 2**31 - 1, -1, -5, 2**31, 2**32 + 5, 123456789012]
DATA = ([0, 1, 2, 3, 999, 1000, 2**31 - 1, 2**32 - 1]
        + [zlib.crc32(n.encode()) & 0x7FFFFFFF for n in (
            "dropout_0.tmp_0", "fused_multihead_attention_0.tmp_0", "x", "learning_rate_0")])


def _jax_key_data(k):
    import jax

    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_threefry_partitionable_is_on():
    import jax

    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    import jax

    assert prng.key_data(prng.key(seed)) == _jax_key_data(jax.random.key(seed))


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_fold_in_and_randint_match_jax(seed):
    import jax
    import jax.numpy as jnp

    for data in DATA:
        jk = jax.random.fold_in(jax.random.key(seed), data)
        pk = prng.fold_in(prng.key(seed), data)
        assert prng.key_data(pk) == _jax_key_data(jk)
        want = [int(x) for x in jax.random.randint(jk, (1,), 0, 2**31 - 1, jnp.int32)]
        assert prng.randint(pk, 1, 0, 2**31 - 1) == want
        want = [int(x) for x in jax.random.randint(jk, (5,), -7, 1000, jnp.int32)]
        assert prng.randint(pk, 5, -7, 1000) == want


def test_many_run_and_name_keys_match_jax():
    """The executor's per-run keys and LoweringContext.rng_for over a few
    hundred (seed, counter, name) triples."""
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    for seed in rs.randint(0, 2**31 - 1, size=20):
        for counter in (1, 2, 3, 17):
            run_j = jax.random.fold_in(jax.random.key(int(seed)), counter)
            run_p = prng.fold_in(prng.key(int(seed)), counter)
            for name in ("dropout_3.tmp_0", "fused_multihead_attention_11.tmp_0",
                         f"v{rs.randint(10**6)}"):
                jk = jax.random.fold_in(run_j, zlib.crc32(name.encode()) & 0x7FFFFFFF)
                pk = prng.name_key(run_p, name)
                assert prng.key_data(pk) == _jax_key_data(jk)
                assert prng.randint(pk, 1, 0, 2**31 - 1)[0] == int(
                    jax.random.randint(jk, (1,), 0, 2**31 - 1, jnp.int32)[0])


def test_split_and_bits_match_jax():
    import jax

    k = prng.fold_in(prng.key(3), 11)
    jk = jax.random.fold_in(jax.random.key(3), 11)
    assert [prng.key_data(s) for s in prng.split(k, 4)] == [
        _jax_key_data(s) for s in jax.random.split(jk, 4)]
    assert prng.random_bits(k, 6) == [int(x) for x in np.asarray(
        jax.random.bits(jk, (6,), np.uint32))]


def test_randint_rejects_bad_bounds():
    with pytest.raises(ValueError):
        prng.randint(prng.key(0), 1, 5, 2**31)

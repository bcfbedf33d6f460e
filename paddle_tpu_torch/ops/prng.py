"""Threefry-2x32 keys in plain Python integers, bit for bit the keys of the
JAX package.

The JAX package draws every random number of a training step from
`jax.random` keys (threefry2x32, with `jax_threefry_partitionable` on, the
default of jax 0.9): the executor's per-run key
`fold_in(key(random_seed or 42), counter + 1)` (paddle_tpu/executor.py:
889-891), the per-variable key `fold_in(run_key, crc32(name) & 0x7fffffff)`
(ops/registry.py:250), the dropout seed words `key_data(key)`
(nn_ops.py:733) and the attention kernels' int32 seed
`randint(key, (1,), 0, 2**31 - 1, int32)` (mha_short.py:567-570,
flash_attention.py:634-636). The port reproduces those few scalars on the
host, so its dropout masks equal the JAX package's. A key is a tuple of
two uint32 ints.

The dygraph `Dropout` (paddle_tpu/dygraph/nn.py:289-311) draws its mask
with `jax.random.bernoulli(key, 1 - p, shape)`: `bernoulli_mask` computes
the same bits on a device, a threefry per element in int64 arithmetic
masked to 32 bits, from a key held as a device tensor of two words, so a
replayed CUDA graph draws the mask of whatever key was written into that
tensor before the replay.
"""

from __future__ import annotations

import zlib

__all__ = ["key", "fold_in", "split", "random_bits", "key_data", "randint",
           "name_key", "attention_seed", "dropout_seed", "key_tensor",
           "random_bits_tensor", "bernoulli_mask"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block (20 rounds) on one pair of counter words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def key(seed: int):
    """jax.random.key(seed): with 64-bit mode off the seed is an int32,
    split into (high word, low word) = (0 or sign, seed mod 2**32)."""
    s = int(seed) & _M32
    s = s - (1 << 32) if s >= 1 << 31 else s  # the int32 the seed becomes
    return (0, s & _M32)


def fold_in(k, data: int):
    """jax.random.fold_in: threefry of the key over the counter (0, data)."""
    return threefry2x32(k[0], k[1], 0, int(data) & _M32)


def split(k, num: int = 2):
    """jax.random.split, partitionable form: key i is threefry over (0, i)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def random_bits(k, n: int):
    """n 32-bit words of jax.random.bits, partitionable form: word i is the
    xor of the two threefry outputs over the counter (0, i)."""
    return [a ^ b for a, b in (threefry2x32(k[0], k[1], 0, i) for i in range(n))]


def key_data(k):
    """jax.random.key_data: the two uint32 words of the key."""
    return (k[0], k[1])


def randint(k, n: int, minval: int, maxval: int):
    """jax.random.randint(k, (n,), minval, maxval, int32) as Python ints:
    higher and lower bits from the two halves of a split key, folded into
    the span through the multiplier 2**32 mod span, all in uint32
    arithmetic as jax does it."""
    if not -(1 << 31) <= minval <= maxval <= (1 << 31) - 1:
        raise ValueError("randint: bounds must be int32 with minval <= maxval")
    k1, k2 = split(k, 2)
    higher, lower = random_bits(k1, n), random_bits(k2, n)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    out = []
    for hi, lo in zip(higher, lower):
        offset = ((((hi % span) * multiplier) & _M32) + lo % span) & _M32
        v = (minval + offset % span) & _M32
        out.append(v - (1 << 32) if v >= 1 << 31 else v)
    return out


def name_key(run_key, name: str):
    """LoweringContext.rng_for: the run key folded with the crc32 of a
    variable name, so a forward op and its grad op draw the same bits."""
    return fold_in(run_key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def attention_seed(k) -> int:
    """The attention kernels' int32 dropout seed of key `k`:
    randint(k, (1,), 0, 2**31 - 1) (mha_short.py:567-570,
    flash_attention.py:634-636 of the JAX package)."""
    return randint(k, 1, 0, (1 << 31) - 1)[0]


def _murmur_mix(x):
    """The murmur3 finalizer on a uint32 int."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def dropout_seed(k) -> int:
    """The dropout op's seed word of key `k`: its two words mixed by the
    murmur3 finalizer (nn_ops.py:720-741 of the JAX package)."""
    return _murmur_mix(((k[0] * 0x9E3779B1) & _M32) ^ k[1])


def key_tensor(k, device=None):
    """A host key as the int64 device tensor of its two words."""
    import torch

    return torch.tensor(key_data(k), dtype=torch.int64, device=device)


def _threefry2x32_tensor(k1, k2, x1, x2):
    """threefry2x32 over int64 tensors of 32-bit words, elementwise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def random_bits_tensor(key_t, n: int):
    """`random_bits` on the device of `key_t` (int64, two words): n words
    as an int64 tensor, word i the xor of threefry over (0, i)."""
    import torch

    k1, k2 = key_t[0], key_t[1]
    ctr = torch.arange(n, dtype=torch.int64, device=key_t.device)
    a, b = _threefry2x32_tensor(k1, k2, torch.zeros_like(ctr), ctr)
    return a ^ b


def bernoulli_mask(key_t, p_keep: float, shape):
    """jax.random.bernoulli(key, p_keep, shape) bit for bit: the top 23
    bits of each word as the mantissa of a float in [1, 2), less 1, below
    p_keep."""
    import torch

    n = 1
    for d in shape:
        n *= int(d)
    bits = random_bits_tensor(key_t, n)
    u = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    return (u < p_keep).reshape(tuple(shape))

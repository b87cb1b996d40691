"""A numpy copy of the few `jax.random` functions augmentation draws
from, on the threefry2x32 generator, bit for bit (counterpart of what
the reference's `data/augment.py` calls in `jax.random`).

A key is a uint32 array of shape (..., 2); every function here maps
over the leading axes, so one call draws for a whole batch, or for every
step of a chunk. The layouts are those of JAX with
`jax_threefry_partitionable` on (its default since JAX 0.5): `split(key,
n)[i]` and the i-th word of `random_bits(key, 32, (n,))` both hash the
64-bit counter i under the key, which makes `split` the same function as
`fold_in(key, i)`.

- `key(seed)`: [0, seed mod 2^32] (a non-negative seed below 2^32);
- `fold_in(key, data)`: threefry2x32(key, [0, data mod 2^32]);
- `split(key, n)`: the n keys threefry2x32(key, [0, i]);
- `random_bits32(key, n)`: y0 ^ y1 of threefry2x32(key, [0, i]);
- `randint(key, n, lo, hi)`: `jax.random.randint`'s two 32-bit draws
  from `split(key, 2)`, combined by its modular reduction;
- `bernoulli_half(key)`: `jax.random.bernoulli(key)` at p = 0.5, which
  is true when the top bit of the key's one 32-bit draw is clear;
- `uniform(key, shape, minval, maxval)`: float32 from the top 23 bits of
  each 32-bit draw (the mantissa of a float in [1, 2), less 1), times
  (maxval - minval) plus minval rounded once (XLA contracts the two
  into one fused multiply-add), floored at minval;
- `gumbel(key, shape)`: `-log(-log(uniform(minval=tiny, maxval=1)))`,
  `jax.random.gumbel`'s default mode "low", in float32;
- `categorical(key, logits)`: argmax over the last axis of the logits
  plus `gumbel` noise of their shape (the sampler generation uses).
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round threefry2x32 block of JAX's `threefry2x32_p` on the
    counter words (x0, x1), broadcast against the key's leading axes."""
    with np.errstate(over="ignore"):      # uint32 sums wrap, as in JAX
        return _rounds(np.asarray(key, np.uint32), x0, x1)


def _rounds(key: np.ndarray, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s threefry data for 0 <= seed < 2^32."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed}: want 0 <= seed < 2**32")
    return np.array([0, seed], np.uint32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """`jax.random.fold_in(k, data)`; `data` (an int or an integer array,
    taken mod 2^32) broadcasts against k's leading axes."""
    data = np.asarray(data).astype(np.int64).astype(np.uint32)
    return np.stack(threefry2x32(k, 0, data), -1)


def split(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.split(k, n)`: shape (..., n, 2)."""
    return fold_in(np.asarray(k, np.uint32)[..., None, :], np.arange(n))


def random_bits32(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.bits(k, (n,), uint32)`: shape (..., n)."""
    y0, y1 = threefry2x32(np.asarray(k, np.uint32)[..., None, :], 0,
                          np.arange(n, dtype=np.uint32))
    return y0 ^ y1


def randint(k: np.ndarray, n: int, lo: int, hi: int) -> np.ndarray:
    """`jax.random.randint(k, (n,), lo, hi)` (int32, lo < hi both in
    int32's range): shape (..., n)."""
    k1, k2 = np.moveaxis(split(k, 2), -2, 0)
    higher, lower = random_bits32(k1, n), random_bits32(k2, n)
    span = np.uint32(hi - lo)
    mult = (1 << 16) % int(span)
    mult = np.uint32((mult * mult & 0xFFFFFFFF) % int(span))  # wraps
    off = (higher % span) * mult + lower % span
    return (lo + (off % span).astype(np.int64)).astype(np.int32)


def bernoulli_half(k: np.ndarray) -> np.ndarray:
    """`jax.random.bernoulli(k)` (p = 0.5): shape (...)."""
    return (random_bits32(k, 1)[..., 0] >> np.uint32(31)) == 0


def uniform(k: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(k, shape, float32, minval, maxval)` for one
    key: the draws of the flattened shape in order."""
    shape = tuple(shape)
    bits = random_bits32(k, int(np.prod(shape, dtype=np.int64)))
    one = np.float32(1.0).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # One rounding of floats * span + lo, as a fused multiply-add: the
    # float64 product of two float32 values is exact.
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32)).reshape(shape)


def gumbel(k: np.ndarray, shape) -> np.ndarray:
    """`jax.random.gumbel(k, shape)` (float32, mode "low")."""
    u = uniform(k, shape, np.finfo(np.float32).tiny, 1.0)
    return -np.log(-np.log(u))


def categorical(k: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """`jax.random.categorical(k, logits, axis=-1)` for float32 logits."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(k, logits.shape) + logits, axis=-1)

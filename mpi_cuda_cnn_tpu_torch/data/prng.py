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
  plus `gumbel` noise of their shape (the sampler generation uses);
- `normal(key, shape, device)`: `jax.random.normal(key, shape)` in
  float32, `sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0), 1))`,
  the seeded inits' draw (`models/initializers.py`,
  `models/transformer.py`, `parallel/moe.py`), drawn here on the host
  and moved to `device`: XLA's float32 `erf_inv` (the Giles polynomial
  after a `log1p` of XLA's own: a Cephes rational below sqrt(2) - 1, a
  Cephes `log` of 1 + x above) step by step, each float32 operation
  rounded once: a quotient of float32 values taken in float64 and
  rounded, a fused multiply-add as one float64 sum of an exact product.
"""

from __future__ import annotations

import numpy as np
import torch

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


def random_bits32(k: np.ndarray, n: int, start: int = 0) -> np.ndarray:
    """`jax.random.bits(k, (N,), uint32)[start:start + n]` for any N >=
    start + n: shape (..., n)."""
    y0, y1 = threefry2x32(np.asarray(k, np.uint32)[..., None, :], 0,
                          np.arange(start, start + n, dtype=np.uint32))
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
    n = int(np.prod(shape, dtype=np.int64))
    return _uniform_words(k, 0, n, minval, maxval).reshape(shape)


def _uniform_words(k: np.ndarray, start: int, stop: int, minval: float,
                   maxval: float) -> np.ndarray:
    """Draws start..stop-1 of `uniform(k, (N,), minval, maxval)`, flat."""
    bits = random_bits32(k, stop - start, start)
    one = np.float32(1.0).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # One rounding of floats * span + lo, as a fused multiply-add: the
    # float64 product of two float32 values is exact.
    fma = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fma.astype(np.float32))


def gumbel(k: np.ndarray, shape) -> np.ndarray:
    """`jax.random.gumbel(k, shape)` (float32, mode "low")."""
    u = uniform(k, shape, np.finfo(np.float32).tiny, 1.0)
    return -np.log(-np.log(u))


def categorical(k: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """`jax.random.categorical(k, logits, axis=-1)` for float32 logits."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(k, logits.shape) + logits, axis=-1)


# ---------------------------------------------------------------------------
# normal: XLA's float32 erf_inv of uniform draws
# ---------------------------------------------------------------------------

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (float32 values, or float64 copies
    of them): the float64 product of two float32 values is exact."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    """XLA's `EvaluatePolynomial`: p = p * x + c from the first
    coefficient, each step one fused multiply-add."""
    x64 = x.astype(np.float64)
    p = np.zeros_like(x)
    for c in coeffs:
        p = (p * x64 + np.float64(_F32(c))).astype(np.float32)
    return p


# XLA's float32 log1p (elemental_ir_emitter's EmitLog1p): below
# |x| < sqrt(2) - 1 the Cephes rational, else log(1 + x) by the Cephes
# logf of XLA's CPU backend (polynomial_approximations.cc).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = tuple(_F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _logf(v: np.ndarray) -> np.ndarray:
    """Cephes logf of positive normal float32 v, step by step."""
    m, e = np.frexp(v)                          # v = m 2^e, m in [0.5, 1)
    e = e.astype(np.float32)
    low = m < _F32(0.707106781186547524)
    x = (m - _F32(1)) + np.where(low, m, _F32(0))   # each term exact
    e = e - low.astype(np.float32)
    x2 = x * x
    x3 = (x2 * x).astype(np.float64)
    x64 = x.astype(np.float64)
    y = _fma(x64, _LOG_P[0], _LOG_P[1])
    y1 = _fma(x64, _LOG_P[3], _LOG_P[4])
    y2 = _fma(x64, _LOG_P[6], _LOG_P[7])
    y = _fma(y, x64, _LOG_P[2])
    y1 = _fma(y1, x64, _LOG_P[5])
    y2 = _fma(y2, x64, _LOG_P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _F32(-2.12194440e-4))
    x = x - x2 * _F32(0.5)
    x = x + y
    return x + e * _F32(0.693359375)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p of x in (-1, 0], each branch on its own
    elements."""
    out = np.empty_like(x)
    small = np.abs(x) < _F32(0.41421356237309504880)
    xl = x[small]
    xs = xl * xl
    ratio = (_horner(xl, _LOG1P_NUM).astype(np.float64)
             / _horner(xl, _LOG1P_DEN)).astype(np.float32)
    out[small] = xl + (_F32(-0.5) * xs + xl * xs * ratio)
    out[~small] = _logf(x[~small] + _F32(1))
    return out


# XLA's float32 ErfInv (Giles): 9-term polynomials in w - 2.5 (w < 5) or
# sqrt(w) - 3, w = -log1p(-x^2).
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv of x in (-1, 1)."""
    w = -_log1p(x * -x)
    lt = w < _F32(5)
    p = np.empty_like(w)
    p[lt] = _horner(w[lt] - _F32(2.5), _ERFINV_LT)
    p[~lt] = _horner(np.sqrt(w[~lt].astype(np.float64)).astype(np.float32)
                     - _F32(3), _ERFINV_GE)
    return p * x


# Draws taken at a time: a block's float64 temporaries stay in cache
# (a whole 8M-draw tensor at once ran 3x slower).
_BLOCK = 1 << 16


def normal(k: np.ndarray, shape, device="cpu") -> torch.Tensor:
    """`jax.random.normal(k, shape)` (float32) for one key, drawn on the
    host and moved to `device` (on the meta device, which holds no
    values, nothing is drawn)."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.nextafter(_F32(-1), _F32(0))
    out = np.empty(n, np.float32)
    for i in range(0, n, _BLOCK):
        u = _uniform_words(k, i, min(i + _BLOCK, n), lo, 1.0)
        out[i:i + _BLOCK] = _F32(np.sqrt(2)) * _erf_inv(u)
    return torch.from_numpy(out.reshape(shape)).to(device)

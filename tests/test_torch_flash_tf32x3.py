"""numpy emulations of the float32 flash kernels' tensor-core design
(`csrc/flash_fwd.cu` `flash_fwd_f32_kernel`, K7, `csrc/flash_bwd_dq.cu`
`flash_bwd_dq_f32_kernel`, K8, and `csrc/flash_bwd_dkv.cu`
`flash_bwd_dkv_f32_kernel`, K9), which run on `mma.sync.m16n8k8` in tf32
as "3xTF32" (`csrc/mma.cuh`):

(a) tf32 rounding (`cvt.rna.tf32.f32`'s: nearest, ties away from zero,
    to 10 explicit mantissa bits; the kernels compute it as two integer
    operations on the bits, mma.cuh's `tf32`) and the split x -> (hi,
    lo), hi + lo within 2^-22 of x;
(b) the m16n8k8 A / B / C fragment maps, the d permutation of the first
    products (A slot t and B row t take d 2t, slot t + 4 d 2t + 1, so a
    lane reads two neighbouring floats) and the k permutation that lets an
    accumulator tile be the A operand of the next product straight from
    registers (A slot t <-> column 2t, slot t + 4 <-> column 2t + 1, with
    B's rows read in the same order);
(c) the kernels' shared-memory addressing (row stride D + 4 floats)
    costs no more passes than the width of each load needs: the 64-bit A
    and plain B reads two, the 32-bit permuted B reads one (K7's q, k and
    v reads too, from the raw tiles or from hi and lo tiles of the same
    layout);
(d) dq, dk and dv computed as the kernels compute them (three tf32
    products per k-chunk of 8, small terms first, each product summed
    exactly and rounded once to float32, to nearest or, as a tensor core
    may, toward zero; each tile's second products summed from zero and
    added to the running sums in float32; the GQA group's float32
    partials summed in order g = 0..G-1) stay within the card's float32
    tolerances of the float64 result: max error 1e-5 of max|.| and
    relative L2 1e-5 (chip_smoke.py's FLASH_RTOL_OF_MAX and
    FLASH_F32_REL_L2);
(e) o and lse computed as K7 computes them (s = q k^T with all of D in
    one accumulator, the online softmax per 64-key tile in float32, each
    tile's p v summed from zero and added to the alpha-rescaled o) stay
    within the same tolerances of float64 and of `flash_forward_plain`,
    which is itself held to the JAX package's `_flash_forward` (Pallas in
    interpret mode).

The kernels themselves run only on the card, where chip_smoke.py holds
them to their plain versions at these tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mpi_cuda_cnn_tpu.ops.pallas_attention as jfa
from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

NEG_INF = np.float32(-1e30)   # the kernels' masked logit
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4  # a lane's group and thread-in-group


# ---------------------------------------------------------------- (a) tf32


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest tf32 value (10 explicit mantissa bits),
    ties away from zero, as float32: `cvt.rna.tf32.f32`. Adding half of
    the dropped 13 bits to the sign-magnitude pattern and truncating
    rounds the magnitude half away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mma.cuh's `split_tf32`: hi = tf32(x), lo = tf32(x - hi)."""
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # tf32's spacing in [1, 2)
    assert tf32_rna(np.array([one + ulp / 2])) == one + ulp      # tie: away
    assert tf32_rna(np.array([-(one + ulp / 2)])) == -(one + ulp)
    below = np.nextafter(one + ulp / 2, np.float32(0))
    assert tf32_rna(np.array([below])) == one
    assert tf32_rna(np.array([np.float32(1.75) + ulp / 4])) == np.float32(1.75)
    # a carry into the exponent
    assert tf32_rna(np.array([np.float32(2.0) - ulp / 4])) == np.float32(2.0)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-20, 20, 100_000)
         ).astype(np.float32)
    r = tf32_rna(x)
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
    # nearest: within half of tf32's spacing at x
    half = np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float64))[1] - 12)
    assert (np.abs(r.astype(np.float64) - x) <= half).all()


def test_split_hi_plus_lo_is_x_within_2_pow_minus_22():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.integers(-15, 15, 200_000)
         ).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(np.uint32) & 0x1FFF == 0).all()   # both are tf32
    x64 = x.astype(np.float64)
    err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - x64)
    assert (err <= 2.0 ** -22 * np.abs(x64)).all()
    # x - hi is exact in float32 (no rounding in the split's subtraction)
    assert np.array_equal((x - hi).astype(np.float64), x64 - hi.astype(np.float64))


# ------------------------------------------------ (b) fragments, (c) banks

# m16n8k8 .tf32 (PTX ISA, "Matrix Fragments for mma.m16n8k8"): lane
# (g, t) holds A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
# a3 (g + 8, t + 4); B (8 x 8, [k][n]) b0 (t, g), b1 (t + 4, g); C / D
# (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
A_MAP = [(G, T), (G + 8, T), (G, T + 4), (G + 8, T + 4)]
B_MAP = [(T, G), (T + 4, G)]
C_MAP = [(G, 2 * T), (G, 2 * T + 1), (G + 8, 2 * T), (G + 8, 2 * T + 1)]
# The accumulators of n-tile j, as the A fragment of k-chunk j: slots
# (a0, a1, a2, a3) <- (c0, c2, c1, c3), so A slot t is column 2t and slot
# t + 4 column 2t + 1.
C_TO_A = (0, 2, 1, 3)


def mma_m16n8k8(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One warp's mma on lane registers a (32, 4), b (32, 2), c (32, 4):
    the matrices the maps say, D = A B + C, back as lane registers."""
    am, bm, cm = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for i, (r, col) in enumerate(A_MAP):
        am[r, col] = a[:, i]
    for i, (r, col) in enumerate(B_MAP):
        bm[r, col] = b[:, i]
    for i, (r, col) in enumerate(C_MAP):
        cm[r, col] = c[:, i]
    dm = am @ bm + cm
    return np.stack([dm[r, col] for r, col in C_MAP], axis=1)


def ld(d: int) -> int:
    """Row stride (floats) of every float32 tile of K8 and K9: D + 4, 16
    bytes of padding (`kLdF32` in flash_common.cuh)."""
    return d + 4


def d_of_slot(slot_col: np.ndarray) -> np.ndarray:
    """The first products' d permutation inside a k-chunk: slot t -> d
    2t, slot t + 4 -> d 2t + 1."""
    return 2 * (slot_col % 4) + slot_col // 4


def a_offset(d: int, warp: int, kc: int, slot: int) -> np.ndarray:
    """flash_common.cuh's `frag_a_tf32`: A slot `slot` of k-chunk kc of
    the warp's 16 rows of a row-major [row][d] tile: a0 and a2 are the
    float2 at (g, 2t), a1 and a3 the one at (g + 8, 2t)."""
    r, col = A_MAP[slot]
    return (16 * warp + r) * ld(d) + kc * 8 + d_of_slot(col)


def b_plain_offset(d: int, n0: int, kc: int, slot: int) -> np.ndarray:
    """`frag_b_tf32`: B of s = q k^T (K8) or s^T = k q^T (K9), the [n][d]
    tile as the col-major B: b0, b1 the float2 at (n0 + g, kc * 8 + 2t)."""
    k, n = B_MAP[slot]
    return (n0 + n) * ld(d) + kc * 8 + d_of_slot(k)


def b_perm_offset(d: int, k0: int, dn: int, slot: int) -> np.ndarray:
    """`permuted_product_tf32x3`: B of dq += ds k (K8) or dv += p^T dO,
    dk += ds^T q (K9), the [k][d] tile as the row-major B with its k index
    permuted like A's:
    slot 0 (row t) reads row k0 + 2t, slot 1 (row t + 4) row k0 + 2t + 1;
    column dn * 8 + g."""
    return (k0 + 2 * T + slot) * ld(d) + dn * 8 + G


def test_accumulators_as_a_operand_with_permuted_b_rows():
    """ds (16 rows x 64 keys) in its accumulator fragments, used as the A
    operand of ds @ k with k's rows read through `b_perm_offset`, is the
    plain product; so is s = q k^T with q through `a_offset` and k
    through `b_plain_offset`."""
    rng = np.random.default_rng(2)
    for d in fa.HEAD_DIMS:
        x = rng.standard_normal((16, 64))          # one warp's ds rows
        k_tile = rng.standard_normal((64, ld(d)))  # k as stored, padded
        k_flat = k_tile.reshape(-1)
        acc = [np.stack([x[r, 8 * j + col] for r, col in C_MAP], axis=1)
               for j in range(8)]                  # n-tile j's registers
        for dn in range(d // 8):
            out = np.zeros((32, 4))
            for j in range(8):                     # key chunk j
                a = acc[j][:, C_TO_A]
                b = np.stack([k_flat[b_perm_offset(d, 8 * j, dn, e)]
                              for e in range(2)], axis=1)
                out = mma_m16n8k8(a, b, out)
            want = x @ k_tile[:, dn * 8:dn * 8 + 8]
            got = np.zeros((16, 8))
            for i, (r, col) in enumerate(C_MAP):
                got[r, col] = out[:, i]
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

        q_tile = rng.standard_normal((64, ld(d)))
        q_flat = q_tile.reshape(-1)
        for warp in range(4):
            for j in range(8):                     # key n-tile j
                out = np.zeros((32, 4))
                for kc in range(d // 8):
                    a = np.stack([q_flat[a_offset(d, warp, kc, e)]
                                  for e in range(4)], axis=1)
                    b = np.stack([k_flat[b_plain_offset(d, 8 * j, kc, e)]
                                  for e in range(2)], axis=1)
                    out = mma_m16n8k8(a, b, out)
                want = (q_tile[16 * warp:16 * warp + 16, :d]
                        @ k_tile[8 * j:8 * j + 8, :d].T)
                got = np.zeros((16, 8))
                for i, (r, col) in enumerate(C_MAP):
                    got[r, col] = out[:, i]
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _passes_32(offsets: np.ndarray) -> int:
    """Passes a warp's 32-bit shared load takes: the most distinct words
    on one bank."""
    banks = offsets % 32
    return max(len(np.unique(offsets[banks == b])) for b in np.unique(banks))


def _passes_128(offsets: np.ndarray) -> int:
    """The same for a 128-bit load (offsets multiples of 4 floats), which
    the card serves a quarter warp at a time: per quarter, the most
    distinct 16-byte words on one group of 4 banks; 512 bytes take at
    least four."""
    words = offsets // 4
    return sum(max(len(np.unique(q[(q % 8) == b])) for b in np.unique(q % 8))
               for q in words.reshape(4, 8))


def _passes_64(offsets: np.ndarray) -> int:
    """The same for a 64-bit load from float offsets `offsets` (even): the
    most distinct 8-byte words on one bank pair; 256 bytes take at least
    two."""
    words = offsets // 2
    pairs = words % 16
    return max(len(np.unique(words[pairs == b])) for b in np.unique(pairs))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_memory_reads_take_no_extra_passes(d):
    """The float32 shared loads of K7, K8 and K9 under the D + 4 stride:
    the 64-bit A and plain B reads (8-byte word 2g + t of the row pair,
    two lanes on each bank pair) take the two passes 256 bytes need; the
    32-bit permuted B reads (bank 8t + g) one. K7 reads q as the A
    operand (from its staging tile into registers at D <= 64, from q's
    hi and lo tiles at D 128), k as the plain B and v as the permuted B,
    from the raw tiles or from hi and lo tiles of the same layout: the
    same offsets. Without the pad (stride D) the permuted read would put
    4 lanes on a bank."""
    assert (ld(d) * 4) % 16 == 0        # rows stay 16-byte aligned for cp.async
    for warp in range(4):
        for kc in range(d // 8):
            for e in (0, 1):            # a0/a2 and a1/a3: one float2 each
                lo, hi = a_offset(d, warp, kc, e), a_offset(d, warp, kc, e + 2)
                assert (hi == lo + 1).all() and (lo % 2 == 0).all()
                assert _passes_64(lo) == 2
    for n0 in range(0, 64, 8):
        for kc in range(d // 8):
            lo, hi = b_plain_offset(d, n0, kc, 0), b_plain_offset(d, n0, kc, 1)
            assert (hi == lo + 1).all() and (lo % 2 == 0).all()
            assert _passes_64(lo) == 2
            for e in range(2):
                assert _passes_32(b_perm_offset(d, n0, kc, e)) == 1
    unpadded = (2 * T) * d + G
    assert _passes_32(unpadded) == 4
    # K7 (flash_fwd.cu), its own expressions: q at arow + kc * 8 (rows g
    # and g + 8), k at (8j + g) * kLd + kc * 8 + 2t, v at 2t * kLd + g +
    # 8j * kLd + dn * 8 (+ kLd for the second B row); the split pass reads
    # and writes whole float4s, row r = e / kWords, column 4 (e % kWords),
    # kWords = D / 4 rounded up to a multiple of 8.
    arow = (16 * np.arange(4)[:, None] + G) * ld(d) + 2 * T
    for warp in range(4):
        for kc in range(d // 8):
            for e, rows8 in ((0, 0), (1, 8)):
                off = arow[warp] + kc * 8 + rows8 * ld(d)
                assert np.array_equal(off, a_offset(d, warp, kc, e))
                assert _passes_64(off) == 2
    for j in range(8):
        for kc in range(d // 8):
            off = (8 * j + G) * ld(d) + kc * 8 + 2 * T
            assert np.array_equal(off, b_plain_offset(d, 8 * j, kc, 0))
            assert _passes_64(off) == 2
        for dn in range(d // 8):
            for e in range(2):
                off = 2 * T * ld(d) + G + 8 * j * ld(d) + dn * 8 + e * ld(d)
                assert np.array_equal(off, b_perm_offset(d, 8 * j, dn, e))
                assert _passes_32(off) == 1
    # K7 splits q in shared memory only beyond D 64 (below, q's fragments
    # are split into registers); at D 16, whose 80-byte rows would put two
    # 16-byte words of a quarter warp on one bank group, it never runs.
    if d < 32:
        return
    # split_tile's lanes: a row's d / 4 16-byte words padded to whole
    # quarter warps (kWords), the lanes past d idle; each quarter warp
    # with a lane at work takes one pass
    words = -(-d // 32) * 8
    for w0 in range(0, 64 * words, 32):
        e = w0 + LANES
        col = 4 * (e % words)
        off = (e // words) * ld(d) + col
        for q, c in zip(off.reshape(4, 8), col.reshape(4, 8)):
            w = q[c < d] // 4
            if len(w):
                assert max(len(np.unique(w[w % 8 == b]))
                           for b in np.unique(w % 8)) == 1


# ------------------------------------------------------- (d) the algorithm


def round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


ROUNDING = {"nearest": lambda x: x.astype(np.float32),
            "toward zero": round_toward_zero}


def mma3(acc: np.ndarray, a: np.ndarray, b: np.ndarray, rnd) -> np.ndarray:
    """mma.cuh's `mma_tf32x3` over one k-chunk of 8: lo.hi, hi.lo, then
    hi.hi into one float32 accumulator; each product of tf32 values is
    exact and its sum with the accumulator is rounded once by `rnd`."""
    ah, al = split(a)
    bh, bl = split(b)
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        acc = rnd(acc.astype(np.float64) + np.matmul(x.astype(np.float64),
                                                     y.astype(np.float64)))
    return acc


def gemm3(a: np.ndarray, b: np.ndarray, rnd, tile: int = 0) -> np.ndarray:
    """a (..., M, K) @ b (..., K, N) as the kernels take it: k-chunks of 8
    in order. tile = 0: all of K in the tensor core's accumulator (the
    first products, K = D); else each run of `tile` chunks from zero,
    added to the float32 sum (the second products, over keys or queries:
    `permuted_product_tf32x3`)."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    step = 8 * (tile or a.shape[-1] // 8)
    for t0 in range(0, a.shape[-1], step):
        acc = np.zeros_like(out)
        for c in range(t0, t0 + step, 8):
            acc = mma3(acc, a[..., c:c + 8], b[..., c:c + 8, :], rnd)
        out = acc if not tile else out + acc
    return out


def emulate(q, k, v, g, lse, dvec, causal, rnd):
    """dq, dk, dv as K8 and K9 compute them in float32. q, g (B, S, H, D);
    k, v (B, S, Hkv, D); lse, dvec (B * H, S). Masked logits are NEG_INF,
    so p and ds are exactly 0 there and add nothing. K8 sums 8 key chunks
    a tile; K9 8 query chunks, 4 at D 128 (its query sub-tiles)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = np.float32(1.0 / d ** 0.5)
    qh, gh = q.transpose(0, 2, 1, 3), g.transpose(0, 2, 1, 3)       # B H S D
    kh = np.repeat(k.transpose(0, 2, 1, 3), group, axis=1)         # kv head h // G
    vh = np.repeat(v.transpose(0, 2, 1, 3), group, axis=1)
    l_ = lse.reshape(b, h, s, 1)
    dv_ = dvec.reshape(b, h, s, 1)
    keep = (np.tril(np.ones((s, s), bool)) if causal
            else np.ones((s, s), bool))
    # K8: s = q k^T, dp = dO v^T; p, ds on the accumulators; dq = ds k
    sq = gemm3(qh, kh.swapaxes(-1, -2), rnd)
    dp = gemm3(gh, vh.swapaxes(-1, -2), rnd)
    p = np.exp(np.where(keep, sq * scale, NEG_INF) - l_)
    ds = p * (dp - dv_) * scale
    dq = gemm3(ds, kh, rnd, tile=8)
    # K9, per query head: s^T = k q^T, dp^T = v dO^T; dv = p^T dO,
    # dk = ds^T q; the group's partials summed in order g = 0..G-1
    st = gemm3(kh, qh.swapaxes(-1, -2), rnd)
    dpt = gemm3(vh, gh.swapaxes(-1, -2), rnd)
    pt = np.exp(np.where(keep.T, st * scale, NEG_INF) - l_.swapaxes(-1, -2))
    dst = pt * (dpt - dv_.swapaxes(-1, -2)) * scale
    sub = 8 if d <= 64 else 4
    part_dv, part_dk = gemm3(pt, gh, rnd, sub), gemm3(dst, qh, rnd, sub)
    dk = np.zeros((b, hkv, s, d), np.float32)
    dv = np.zeros_like(dk)
    for gi in range(group):
        dk = dk + part_dk[:, gi::group]
        dv = dv + part_dv[:, gi::group]
    return (dq.transpose(0, 2, 1, 3), dk.transpose(0, 2, 1, 3),
            dv.transpose(0, 2, 1, 3))


def reference64(q, k, v, g, lse, dvec, causal):
    """The same function of the same float32 inputs in float64."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    f = lambda x: x.astype(np.float64)  # noqa: E731
    qh, gh = f(q).transpose(0, 2, 1, 3), f(g).transpose(0, 2, 1, 3)
    kh = np.repeat(f(k).transpose(0, 2, 1, 3), group, axis=1)
    vh = np.repeat(f(v).transpose(0, 2, 1, 3), group, axis=1)
    keep = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    logits = np.where(keep, qh @ kh.swapaxes(-1, -2) / np.sqrt(d), -np.inf)
    p = np.exp(logits - f(lse).reshape(b, h, s, 1))
    ds = p * (gh @ vh.swapaxes(-1, -2) - f(dvec).reshape(b, h, s, 1)) / np.sqrt(d)
    dq = ds @ kh
    dk = (ds.swapaxes(-1, -2) @ qh).reshape(b, hkv, group, s, d).sum(2)
    dv = (p.swapaxes(-1, -2) @ gh).reshape(b, hkv, group, s, d).sum(2)
    return (dq.transpose(0, 2, 1, 3), dk.transpose(0, 2, 1, 3),
            dv.transpose(0, 2, 1, 3))


# (B, S, H, Hkv, D, causal): a causal MHA shape, a causal GQA one over
# four key tiles, and a non-causal one at the flagship's head dim.
EMULATED = {"causal MHA D32": (1, 128, 2, 2, 32, True),
            "causal GQA 4/2 D64": (1, 256, 4, 2, 64, True),
            "non-causal GQA 2/1 D64": (1, 128, 2, 1, 64, False)}


@pytest.mark.parametrize("rounding", ROUNDING)
@pytest.mark.parametrize("name", EMULATED)
def test_3xtf32_backward_within_the_cards_float32_tolerances(name, rounding):
    b, s, h, hkv, d, causal = EMULATED[name]
    rng = np.random.default_rng(3)
    q, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = fa.flash_forward_plain(tq, tk, tv, causal)
    dvec = fa.row_dvec(o, tg)
    lse, dvec = lse.numpy(), dvec.numpy()
    got = emulate(q, k, v, g, lse, dvec, causal, ROUNDING[rounding])
    want = reference64(q, k, v, g, lse, dvec, causal)
    plain = (fa.flash_bwd_dq_plain(tq, tk, tv, tg, torch.from_numpy(lse),
                                   torch.from_numpy(dvec), causal),
             *fa.flash_bwd_dkv_plain(tq, tk, tv, tg, torch.from_numpy(lse),
                                     torch.from_numpy(dvec), causal))
    rtol_of_max = chip_smoke.FLASH_RTOL_OF_MAX["float32"]
    for what, x, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert x.dtype == np.float32 and x.shape == w.shape
        err = np.abs(x - w).max()
        assert err <= rtol_of_max * np.abs(w).max(), (what, err)
        rel = np.linalg.norm(x - w) / np.linalg.norm(w)
        assert rel <= chip_smoke.FLASH_F32_REL_L2, (what, rel)
        # and against the plain version the card holds the kernels to
        pl = pl.numpy()
        assert np.abs(x - pl).max() <= rtol_of_max * np.abs(pl).max(), what
        assert np.linalg.norm(x - pl) / np.linalg.norm(pl) <= chip_smoke.FLASH_F32_REL_L2


def emulate_forward(q, k, v, causal, rnd):
    """o and lse as K7 computes them in float32: per 64-key tile, s = q
    k^T through the tensor core (all of D in one accumulator), the online
    softmax in float32 (masked logits NEG_INF, their p exactly 0), p v
    summed from zero over the tile's 8 key chunks and added to the
    alpha-rescaled o. A causal tile above the diagonal changes nothing
    (alpha 1, p 0), so it is not skipped here. q (B, S, H, D); k, v (B,
    S, Hkv, D); lse (B * H, S)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    scale = np.float32(1.0 / d ** 0.5)
    qh = q.transpose(0, 2, 1, 3)
    kh = np.repeat(k.transpose(0, 2, 1, 3), group, axis=1)
    vh = np.repeat(v.transpose(0, 2, 1, 3), group, axis=1)
    m = np.full((b, h, s, 1), NEG_INF, np.float32)
    l = np.zeros((b, h, s, 1), np.float32)
    o = np.zeros((b, h, s, d), np.float32)
    rows = np.arange(s)[:, None]
    for k0 in range(0, s, 64):
        keep = (k0 + np.arange(64)[None, :] <= rows) if causal else True
        st = gemm3(qh, kh[:, :, k0:k0 + 64].swapaxes(-1, -2), rnd)
        x = np.where(keep, st * scale, NEG_INF)
        m_new = np.maximum(m, x.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.where(keep, np.exp(x - m_new), np.float32(0))
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        o = o * alpha + gemm3(p, vh[:, :, k0:k0 + 64], rnd, tile=8)
        m = m_new
    lc = np.maximum(l, np.float32(1e-30))
    return ((o / lc).transpose(0, 2, 1, 3),
            (m + np.log(lc)).reshape(b * h, s))


def reference64_forward(q, k, v, causal):
    """o and lse of the same float32 inputs in float64."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    f = lambda x: x.astype(np.float64)  # noqa: E731
    qh = f(q).transpose(0, 2, 1, 3)
    kh = np.repeat(f(k).transpose(0, 2, 1, 3), group, axis=1)
    vh = np.repeat(f(v).transpose(0, 2, 1, 3), group, axis=1)
    keep = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    logits = np.where(keep, qh @ kh.swapaxes(-1, -2) / np.sqrt(d), -np.inf)
    mx = logits.max(-1, keepdims=True)
    p = np.exp(logits - mx)
    l = p.sum(-1, keepdims=True)
    return ((p @ vh / l).transpose(0, 2, 1, 3),
            (mx + np.log(l)).reshape(b * h, s))


def _held(what, x, w):
    rtol_of_max = chip_smoke.FLASH_RTOL_OF_MAX["float32"]
    assert x.shape == w.shape, what
    err = np.abs(x - w).max()
    assert err <= rtol_of_max * np.abs(w).max(), (what, err)
    rel = np.linalg.norm(x - w) / np.linalg.norm(w)
    assert rel <= chip_smoke.FLASH_F32_REL_L2, (what, rel)


@pytest.mark.parametrize("rounding", ROUNDING)
@pytest.mark.parametrize("name", EMULATED)
def test_3xtf32_forward_within_the_cards_float32_tolerances(name, rounding):
    b, s, h, hkv, d, causal = EMULATED[name]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    o, lse = emulate_forward(q, k, v, causal, ROUNDING[rounding])
    assert o.dtype == np.float32 and lse.dtype == np.float32
    want_o, want_lse = reference64_forward(q, k, v, causal)
    _held("o vs float64", o, want_o)
    _held("lse vs float64", lse, want_lse)
    # and against the plain version the card holds the kernel to
    po, plse = fa.flash_forward_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal)
    _held("o vs plain", o, po.numpy())
    _held("lse vs plain", lse, plse.numpy())


def test_plain_forward_matches_the_pallas_kernel_at_an_emulated_shape(
        monkeypatch):
    """`flash_forward_plain`, which the card holds K7 to, against the JAX
    package's `_flash_forward` (Pallas in interpret mode, 128-row blocks
    so several q and k blocks run) at the causal GQA shape above."""
    for name in ("BLK_Q", "BLK_K"):
        monkeypatch.setattr(jfa, name, 128)
    b, s, h, hkv, d, causal = EMULATED["causal GQA 4/2 D64"]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    jo, jlse = jax.jit(lambda q, k, v: jfa._flash_forward(
        q, k, v, causal, with_lse=True))(*(jnp.asarray(x) for x in (q, k, v)))
    po, plse = fa.flash_forward_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal)
    _held("o", po.numpy(), np.asarray(jo))
    _held("lse", plse.numpy(), np.asarray(jlse).reshape(b * h, s))

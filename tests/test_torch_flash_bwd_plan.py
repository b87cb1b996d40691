"""The launch plans of the flash kernels: the forward K7
(`flash_attention.flash_fwd_plan`, which `flash_forward` hands to
`csrc/flash_fwd.cu`) and the backward K8 (dq) and K9 (dk/dv)
(`flash_attention.flash_bwd_plan`, which `flash_bwd_dq` and
`flash_bwd_dkv` hand to `csrc/flash_bwd_dq.cu` and `csrc/flash_bwd_dkv.cu`),
at every attention shape the port launches them at: chip_smoke.py's
kernel cases (the LM flagship, GQA 8/2, D 32, D 128 and non-causal, in
float32 and bf16, and each rank's shapes of the `lm_mesh` phase,
`lm_mesh_shapes`: its rows, positions, heads and kv heads on the LM's
sharded meshes), the LM phases' model (`lm`, `lm-bench`, `lm_profile`,
`lm_agree`) in float32 and bf16, and every head dim the kernels are built
for in both types. Both types share one geometry: 128 threads, a block
per (batch, query head, 64-row tile; K9 beyond D 128: two, one per half
of the output columns), the GQA group summed from a float32 scratch.
Every head dim up to 256 maps to the instance `with_head_dim`
(csrc/flash_common.cuh) switches to.

At each, the plan must:
- cover every (batch, query head, 64-row query tile) exactly once by K7
  and by K8;
- cover every (batch, query head, 64-key tile) exactly once by K9, and
  under GQA write every (group slice, batch, key, kv head) of the scratch
  once and have the group sum cover every (dk or dv, batch, key, kv
  head, d) once;
- stay within the grid limits, the threads a block may have and 227 KB
  of shared memory;
- hold a scratch only for K9 with H > Hkv.

The block-to-tile maps below are the kernels' own (`blockIdx` decoding in
the two sources). CPU only: the plan is plain Python; the kernels are held
to their plain versions on the card by chip_smoke.py.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import chip_smoke
from mpi_cuda_cnn_tpu_torch.ops._kernels import CSRC
from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
from mpi_cuda_cnn_tpu_torch.train import lm_bench
from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

SMEM_LIMIT = 227 * 1024            # a block's shared memory on the H100
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535
TILE = 64
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lm_shape(b: int, s: int, dim: int, heads: int, kv_heads: int):
    return (b, s, heads, kv_heads or heads, dim // heads)


def _shapes() -> dict:
    """name -> (dtype, B, S, H, Hkv, D)."""
    out = {}
    for dtype, b, s, h, hkv, d in chip_smoke.FLASH_SHAPES:
        out[f"chip_smoke {dtype} B{b} H{h}/{hkv} D{d}"] = (dtype, b, s, h, hkv, d)
    for dtype, b, s, h, hkv, d, causal in chip_smoke.FLASH_EXTRA_SHAPES:
        out[f"chip_smoke {dtype} B{b} H{h}/{hkv} D{d} causal={causal}"] = (
            dtype, b, s, h, hkv, d)
    for dtype, b, s, h, hkv, d, causal in chip_smoke.lm_mesh_shapes():
        out[f"lm_mesh {dtype} B{b} S{s} H{h}/{hkv} D{d} causal={causal}"] = (
            dtype, b, s, h, hkv, d)
    cfg = parse_lm_args(chip_smoke.LM_MODEL_ARGS)
    bench = lm_bench._parser().parse_args([])
    for dtype in DTYPES:
        out[f"lm {dtype}"] = (dtype, *_lm_shape(
            cfg.batch_size, cfg.seq_len, cfg.dim, cfg.heads, cfg.kv_heads))
        out[f"lm-bench {dtype}"] = (dtype, *_lm_shape(
            bench.batch, bench.seq, bench.dim, bench.heads, bench.kv_heads))
        for d in fa.HEAD_DIMS:
            out[f"{dtype} GQA D{d}"] = (dtype, 2, 1024, 4, 2, d)
            out[f"{dtype} MHA D{d}"] = (dtype, 1, 256, 2, 2, d)
    return out


SHAPES = _shapes()


def _check_limits(plan: fa.FlashBwdPlan) -> None:
    assert 1 <= plan.grid_x <= GRID_X_MAX and 1 <= plan.grid_y <= GRID_Y_MAX
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.sum_blocks == 0 or plan.sum_blocks <= GRID_X_MAX


@pytest.mark.parametrize("name", SHAPES)
def test_dq_plan_covers_every_query_tile_once(name):
    dtype, b, s, h, hkv, d = SHAPES[name]
    plan = fa.flash_bwd_plan("dq", b, s, h, hkv, d, DTYPES[dtype])
    _check_limits(plan)
    assert plan.scratch is None and plan.sum_blocks == 0
    assert plan.threads == 128
    # block (x, y): bh = x -> (x // H, x % H); q tile grid_y - 1 - y
    x, y = np.meshgrid(np.arange(plan.grid_x), np.arange(plan.grid_y),
                       indexing="ij")
    bb, hh, qt = x // h, x % h, plan.grid_y - 1 - y
    assert (bb < b).all() and (qt >= 0).all() and (qt < s // TILE).all()
    cover = np.zeros((b, h, s // TILE), np.int64)
    np.add.at(cover, (bb, hh, qt), 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("name", SHAPES)
def test_dkv_plan_covers_every_key_tile_once(name):
    dtype, b, s, h, hkv, d = SHAPES[name]
    group = h // hkv
    plan = fa.flash_bwd_plan("dkv", b, s, h, hkv, d, DTYPES[dtype])
    _check_limits(plan)
    x, y = np.meshgrid(np.arange(plan.grid_x), np.arange(plan.grid_y),
                       indexing="ij")
    # block (x, y): kt = y / split, dh = y % split (the half of the
    # output columns beyond D 128)
    split = fa.dkv_split(d)
    assert split == (2 if d > 128 else 1)
    kt, dh = y // split, y % split
    cover = np.zeros((b, h, s // TILE, split), np.int64)
    # one block per (batch, query head): the GQA group split across blocks
    assert plan.threads == 128
    bb, hh = x // h, x % h
    assert (bb < b).all() and (kt < s // TILE).all()
    np.add.at(cover, (bb, hh, kt, dh), 1)
    assert (cover == 1).all()
    if group == 1:
        assert plan.scratch is None and plan.sum_blocks == 0
        return
    assert plan.scratch == (2, group, b, s, hkv, d)
    # each block writes its 64 keys (its columns) of slice h % G at kv
    # head h // G
    written = np.zeros((group, b, s // TILE, hkv, split), np.int64)
    np.add.at(written, (hh % group, bb, kt, hh // group, dh), 1)
    assert (written == 1).all()
    # the group sum: thread i < 2 n4 sums 4 floats of dk (i < n4) or dv
    n = b * s * hkv * d
    n4 = n // 4
    i = np.arange(plan.sum_blocks * 256)
    assert plan.sum_blocks * 256 >= 2 * n4 > (plan.sum_blocks - 1) * 256
    i = i[i < 2 * n4]
    which, e = i // n4, i % n4
    summed = np.zeros((2, n), np.int64)
    for lane in range(4):
        np.add.at(summed, (which, 4 * e + lane), 1)
    summed = summed.reshape(2, b, s, hkv, d)
    assert (summed == 1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plan_shared_memory_is_the_kernels_layout(dtype, d):
    """The bytes the sources stage: rows of D elements of the input type,
    each padded by 16 bytes (float32 rows of D + 4 floats, bf16 rows of
    D + 8). K8: the q and dO tiles (64 rows) and k and v tiles of
    `stream_rows` keys (64; 32 beyond D 128) in two stages, one in
    float32. K9: the k and v tiles, two stages of q and dO tiles of
    `stream_rows` queries (64; float32 beyond D 128: 16) and of as many
    float32 lse and dvec values. At D 64 three float32 K8 blocks and two
    K9 blocks fit on an SM."""
    elem = 4 if dtype == "float32" else 2
    dq = fa.flash_bwd_plan("dq", 1, 128, 2, 1, d, DTYPES[dtype])
    dkv = fa.flash_bwd_plan("dkv", 1, 128, 2, 1, d, DTYPES[dtype])
    row = (d + 16 // elem) * elem
    n_dq = 32 if d > 128 else 64
    n_dkv = 16 if d > 128 and elem == 4 else 64
    assert fa.stream_rows("dq", DTYPES[dtype], d) == n_dq
    assert fa.stream_rows("dkv", DTYPES[dtype], d) == n_dkv
    assert dq.smem_bytes == (128 + (2 if elem == 4 else 4) * n_dq) * row
    assert dkv.smem_bytes == (128 + 4 * n_dkv) * row + 4 * 4 * n_dkv
    if d <= 128:      # the 64-row tiles of the kernels before D 256
        tile = 64 * row
        assert dq.smem_bytes == (4 if elem == 4 else 6) * tile
        assert dkv.smem_bytes == 6 * tile + 4 * 4 * 64
    if d == 64 and elem == 4:
        assert 3 * dq.smem_bytes <= 228 * 1024  # the SM's shared memory
        assert 2 * dkv.smem_bytes <= 228 * 1024
    # the row strides: float32 kLdF32<D> = D + 4 (flash_common.cuh), bf16
    # D + 8, 16 bytes of padding each
    stride = ("kLdF32<D>;" if elem == 4 else "D + 8;")
    common = (CSRC / "flash_common.cuh").read_text()
    assert "constexpr int kLdF32 = D + 4;" in common
    assert "constexpr int kStreamRowsDq = D > 128 ? 32 : kTile;" in common
    assert "constexpr int kStreamRowsF32Dkv = D > 128 ? 16 : kTile;" in common
    assert "constexpr int kDkvSplit = D > 128 ? 2 : 1;" in common
    for src in ("flash_bwd_dq.cu", "flash_bwd_dkv.cu"):
        text = (CSRC / src).read_text()
        kern = text[text.index(f"{src[:-3]}_{'f32' if elem == 4 else 'bf16'}_kernel("):]
        kern = kern[:kern.index("\n}\n")]
        assert f"constexpr int kLd = {stride}" in kern
    one_line = " ".join((CSRC / "flash_bwd_dq.cu").read_text().split())
    assert ("constexpr int kStages = std::is_same<T, float>::value ? 1 : 2;"
            in one_line)
    assert ("(2 * kTile + 2 * kStages * kStreamRowsDq<D>) * "
            "(sizeof(T) * D + 16)") in one_line
    one_line = " ".join((CSRC / "flash_bwd_dkv.cu").read_text().split())
    assert ("std::is_same<T, float>::value ? kStreamRowsF32Dkv<D> : kTile;"
            in one_line)
    assert ("(2 * kTile + 4 * kN) * (sizeof(T) * D + 16) + "
            "sizeof(float) * 4 * kN") in one_line


def _switch_dims() -> list[int]:
    """The head dims of `with_head_dim`'s switch (csrc/flash_common.cuh),
    each case checked to hand the kernels its own D."""
    text = (CSRC / "flash_common.cuh").read_text()
    body = text[text.index("cudaError_t with_head_dim("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, "
                       r"(\d+)>\{\}\);", body)
    assert cases and all(a == b for a, b in cases)
    assert "default: return cudaErrorInvalidValue;" in body
    return [int(a) for a, _ in cases]


def test_each_head_dim_maps_to_the_c_switch_instance():
    """The wrapper's instances are the C switch's, and every D in
    1..256 runs at the smallest of them that is >= D (`pad_route`);
    beyond 256 it raises, naming the limit."""
    dims = _switch_dims()
    assert tuple(dims) == fa.HEAD_DIMS and fa.MAX_HEAD_DIM == max(dims) == 256
    assert chip_smoke.FLASH_HEAD_DIMS == fa.HEAD_DIMS   # its HMMA check
    for d in range(1, 257):
        assert fa.kernel_head_dim(d) == min(c for c in dims if c >= d)
    for d in (0, 257, 320):
        with pytest.raises(ValueError, match="1..256"):
            fa.kernel_head_dim(d)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_every_instance_fits_in_a_blocks_shared_memory(dtype):
    """Every instance's K7, K8 and K9 plan at the LM flagship's geometry
    (B 8, S 2048, 8 heads, MHA and GQA 8/2) stays within the 232,448
    bytes (227 KB) a block may have; the plans refuse what the C switch
    lacks."""
    for d in fa.HEAD_DIMS:
        for hkv in (8, 2):
            plans = [fa.flash_fwd_plan(8, 2048, 8, hkv, d, DTYPES[dtype])] + [
                fa.flash_bwd_plan(k, 8, 2048, 8, hkv, d, DTYPES[dtype])
                for k in ("dq", "dkv")]
            for plan in plans:
                assert 0 < plan.smem_bytes <= 232_448, (d, plan)
    for d in (24, 200, 320):
        with pytest.raises(ValueError):
            fa.flash_fwd_plan(8, 2048, 8, 8, d, DTYPES[dtype])
        with pytest.raises(ValueError):
            fa.flash_bwd_plan("dq", 8, 2048, 8, 8, d, DTYPES[dtype])


def test_plan_refuses_what_the_kernels_lack():
    with pytest.raises(ValueError):
        fa.flash_bwd_plan("fwd", 1, 128, 2, 1, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_bwd_plan("dq", 1, 128, 2, 1, 64, torch.float16)


@pytest.mark.parametrize("name", SHAPES)
def test_fwd_plan_covers_every_query_tile_once(name):
    dtype, b, s, h, hkv, d = SHAPES[name]
    plan = fa.flash_fwd_plan(b, s, h, hkv, d, DTYPES[dtype])
    assert 1 <= plan.grid_x <= GRID_X_MAX and 1 <= plan.grid_y <= GRID_Y_MAX
    assert plan.threads == 128
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # block (x, y): bh = x -> (x // H, x % H); q tile grid_y - 1 - y
    x, y = np.meshgrid(np.arange(plan.grid_x), np.arange(plan.grid_y),
                       indexing="ij")
    bb, hh, qt = x // h, x % h, plan.grid_y - 1 - y
    assert (bb < b).all() and (qt >= 0).all() and (qt < s // TILE).all()
    cover = np.zeros((b, h, s // TILE), np.int64)
    np.add.at(cover, (bb, hh, qt), 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fwd_plan_shared_memory_is_the_kernels_layout(dtype, d):
    """The bytes flash_fwd.cu stages: rows of D elements with each row
    padded by 16 bytes; bf16 five 64-row tiles (q and two stages of k and
    v), float32 four (k and v in two stages), six at D 80-128 (q split
    into hi and lo tiles), and beyond D 128 two stages of 32-key k and v
    tiles and q's float32 tile (192 rows). At D 64 two float32 blocks fit
    on an SM."""
    elem = 4 if dtype == "float32" else 2
    plan = fa.flash_fwd_plan(1, 128, 2, 1, d, DTYPES[dtype])
    row = (d + 16 // elem) * elem
    rows = (5 * 64 if elem == 2 else 4 * 64 if d <= 64 else 6 * 64
            if d <= 128 else 4 * 32 + 64)
    assert plan.smem_bytes == rows * row
    assert fa.stream_rows("fwd", DTYPES[dtype], d) == (
        32 if d > 128 and elem == 4 else 64)
    if d == 64 and elem == 4:
        assert 2 * plan.smem_bytes <= 228 * 1024   # the SM's shared memory
    src = (CSRC / "flash_fwd.cu").read_text()
    one_line = " ".join(src.split())
    assert ("constexpr int kF32Rows = D <= 64 ? 4 * kTile : (D <= 128 ? "
            "6 * kTile : 4 * kStreamRowsF32Fwd<D> + kTile);") in one_line
    assert "kF32Rows<D> * (sizeof(float) * D + 16)" in src
    assert "sizeof(__nv_bfloat16) * 5 * kTile * (D + 8)" in src
    assert ("constexpr int kStreamRowsF32Fwd = D > 128 ? 32 : kTile;"
            in (CSRC / "flash_common.cuh").read_text())
    for kern, stride in (("flash_fwd_f32_kernel(", "kLdF32<D>;"),
                         ("flash_fwd_bf16_kernel(", "D + 8;")):
        body = src[src.index(kern):]
        body = body[:body.index("\n}\n")]
        assert f"constexpr int kLd = {stride}" in body


def test_fwd_plan_refuses_what_the_kernel_lacks():
    with pytest.raises(ValueError):
        fa.flash_fwd_plan(1, 128, 2, 1, 64, torch.float16)

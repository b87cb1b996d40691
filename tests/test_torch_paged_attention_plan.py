"""The paged-attention read's launch plan (`paged_attention.
paged_attention_plan`, which `paged_attend` hands to
`csrc/paged_attention.cu`) and a numpy emulation of the kernel's
split-then-merge against the JAX package's `paged_attend` (its Pallas
kernel in interpret mode on the CPU).

The plan, at chip_smoke.py's six serving cases, at serve-bench's
flagship table width (decode over 8 slots, the prefill chunk of 32) and
at the CPU test shapes of tests/test_torch_paged_attention.py, must:
- cover every (slot, kv head, query row, page of the block table)
  exactly once: a block is one (slot, kv head, row group, split), the
  split fastest, and folds its split's pages for its rows;
- stay within the grid, a block's threads and 227 KB of shared memory
  (a two-page ring), at most 16 splits and a copy width that divides the
  row;
- hold a scratch and counters only with more than one split.

The emulation computes what the kernel computes, block by block, from
the plan: each block's visible pages (up to the largest position of its
rows), the online softmax page by page in float32 with the keys of a
page taken 16 at a time (a key's int8 scale on its logit, a
value's on its probability), each split's partial (m, l, acc), and the
merge in split order, a split with no visible key adding nothing. It is
held to the JAX read within the tolerances of
tests/test_torch_paged_attention.py for float32, bf16 and int8 pages,
MHA/GQA/MQA, kk 1 and a chunk, with a slot whose last position lies in
its first page (most of its splits see no key) and padding rows past the
table's extent. The kernel itself runs only on the card, where
chip_smoke.py holds it to the plain version.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mpi_cuda_cnn_tpu.ops.pallas_paged_attention import (
    paged_attend as jax_paged_attend,
)
from mpi_cuda_cnn_tpu_torch.ops.paged_attention import paged_attention_plan
from mpi_cuda_cnn_tpu_torch.serve import bench as serve_bench
from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

SMEM_LIMIT = 227 * 1024
GRID_MAX = 2 ** 31 - 1
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
# tests/test_torch_paged_attention.py's shapes and tolerances
ATOL = {"float32": 1e-5, "int8": 1e-5, "bfloat16": 1e-2}
HEADS, HD, PS, CHUNK = 4, 8, 8, 4
HKV = {"mha": 4, "gqa": 2, "mqa": 1}
KEYS_PER_PASS = 16        # csrc/paged_attention.cu's kKeys


def _serve_flagship() -> dict:
    args = serve_bench._parser().parse_args(chip_smoke.SERVE_ARGS)
    width = pages_for(args.max_seq, args.page_size)
    hd = args.dim // args.heads
    return {f"serve {dtype} {what}": (b, kk, args.heads, args.kv_heads, hd,
                                      args.page_size, width, dtype)
            for dtype in TDT
            for what, b, kk in (("decode", args.slots, 1),
                                ("prefill", 1, args.prefill_chunk))}


def _shapes() -> dict:
    """name -> (B, kk, H, Hkv, hd, ps, npages, pages dtype)."""
    out = {f"chip_smoke {dtype} B{b} kk{kk}": (
        b, kk, chip_smoke.HEADS, chip_smoke.KV_HEADS, chip_smoke.HEAD_DIM,
        chip_smoke.PAGE, chip_smoke.TABLE_PAGES, dtype)
        for dtype in TDT for b, kk in ((8, 1), (1, 32))}
    out.update(_serve_flagship())
    for dtype in TDT:
        for head, hkv in HKV.items():
            for kk in (1, CHUNK):
                out[f"cpu {dtype} {head} kk{kk}"] = (3, kk, HEADS, hkv, HD, PS,
                                                    5, dtype)
    return out


SHAPES = _shapes()


def _blocks(plan):
    """(slot, kv head, row group, split) of every block, as the kernel
    decodes blockIdx.x (split fastest)."""
    bid = np.arange(plan.grid)
    sp = bid % plan.splits
    rest = bid // plan.splits
    rg = rest % plan.row_groups
    rest = rest // plan.row_groups
    return sp, rg, rest


@pytest.mark.parametrize("name", SHAPES)
def test_plan_covers_every_row_and_page_once(name):
    b, kk, h, hkv, hd, ps, npages, dtype = SHAPES[name]
    plan = paged_attention_plan(b, kk, h, hkv, hd, ps, npages, TDT[dtype])
    rows = (h // hkv) * kk
    assert 1 <= plan.grid <= GRID_MAX
    assert plan.threads == 32 * plan.warps and 0 < plan.threads <= 1024
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.splits <= 16 and hd % 4 == 0
    assert (hd * TDT[dtype].itemsize) % plan.copy_bytes == 0
    assert plan.copy_bytes in (16, 8, 4)
    sp, rg, tile = _blocks(plan)
    slot, kvh = tile // hkv, tile % hkv
    assert (slot < b).all() and (rg * plan.warps < rows).all()
    cover = np.zeros((b, hkv, rows, npages), np.int64)
    for s_, r_, b_, k_ in zip(sp, rg, slot, kvh):
        pages = slice(s_ * plan.pages_per_split,
                      min((s_ + 1) * plan.pages_per_split, npages))
        assert pages.start < npages            # no split is empty by plan
        cover[b_, k_, r_ * plan.warps:(r_ + 1) * plan.warps, pages] += 1
    assert (cover == 1).all()
    if plan.splits > 1:
        assert plan.scratch == (b, kk, h, plan.splits, hd + 2)
        assert plan.counters == b * hkv * plan.row_groups
    else:
        assert plan.scratch is None and plan.counters == 0


def test_plan_fills_the_card_at_decode():
    """At chip_smoke's int8 decode shape: 16 (slot, kv head) tiles, 16
    splits of 5 pages, 256 blocks on 132 SMs, a two-page ring."""
    plan = paged_attention_plan(8, 1, 8, 2, 64, 16, 80, torch.int8)
    assert (plan.splits, plan.pages_per_split, plan.grid) == (16, 5, 256)
    assert plan.copy_bytes == 16 and plan.warps == 4
    # table slice 32 + q 4 x 64 x 4 + 2 x (16 x 2 x (64 + 16) + 16 x 8)
    assert plan.smem_bytes == 32 + 1024 + 2 * 2688


def test_plan_refuses_what_the_kernel_lacks():
    for args in ((8, 1, 8, 2, 6, 16, 80, torch.int8),       # hd % 4
                 (8, 1, 8, 2, 512, 16, 80, torch.float32),  # hd > 256
                 (8, 1, 8, 3, 64, 16, 80, torch.int8),      # H % Hkv
                 (8, 1, 8, 2, 64, 16, 80, torch.float16)):
        with pytest.raises(ValueError):
            paged_attention_plan(*args)


def _case(seed, dtype, hkv, kk, *, b=3, npages=5, pool=20):
    """Distinct random block tables, q and pages; slot 0's positions end
    inside its first page (its other pages, and the splits over them, see
    no key), slot 1's mid-table, and slot 2's last rows (a chunk's
    padding) run past the table's extent."""
    rng = np.random.default_rng(seed)
    shape = (pool, PS, hkv, HD)
    if dtype == "int8":
        pages = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "ks": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32),
                 "vs": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)}
    else:
        pages = {n: np.asarray(jnp.asarray(rng.normal(size=shape).astype(np.float32),
                                           jnp.dtype(dtype)))
                 for n in ("k", "v")}
    table = np.stack([rng.choice(np.arange(1, pool), npages, replace=False)
                      for _ in range(b)]).astype(np.int32)
    last = np.array([PS // 2, (npages - 2) * PS + 3, npages * PS + kk])
    positions = (last[:, None] - kk + 1 + np.arange(kk)[None, :]).astype(np.int32)
    positions[0] = np.maximum(positions[0], 0)
    q = rng.normal(size=(b, kk, HEADS, HD)).astype(np.float32)
    return q, pages, table, positions


def emulate(q, pages, positions, table, plan):
    """The kernel's arithmetic per the plan, in float32 (see the module
    docstring). Returns (B, kk, H * hd)."""
    b, kk, h, hd = q.shape
    hkv = pages["k"].shape[2]
    grp, rows, npages = h // hkv, (h // hkv) * kk, table.shape[1]
    int8 = pages["k"].dtype == np.int8
    kf = pages["k"].astype(np.float32)
    vf = pages["v"].astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(hd))
    ninf = np.float32(-np.inf)
    part = {}
    sp_, rg_, tile_ = _blocks(plan)
    for sp, rg, tile in zip(sp_, rg_, tile_):
        bb, kvh = tile // hkv, tile % hkv
        mine = [r for r in range(rg * plan.warps, (rg + 1) * plan.warps)
                if r < rows]
        n_vis = min(npages, max(positions[bb, r % kk] for r in mine) // PS + 1)
        p0 = sp * plan.pages_per_split
        for r in mine:
            gi, j = divmod(r, kk)
            hh, pos = kvh * grp + gi, positions[bb, j]
            m, l, acc = ninf, np.float32(0), np.zeros(hd, np.float32)
            for pg in range(p0, min(p0 + plan.pages_per_split, n_vis)):
                page = table[bb, pg]
                for c in range(0, PS, KEYS_PER_PASS):
                    keys = np.arange(c, min(c + KEYS_PER_PASS, PS))
                    valid = pg * PS + keys <= pos
                    logit = kf[page, keys, kvh] @ q[bb, j, hh] * scale
                    if int8:
                        logit = logit * pages["ks"][page, keys, kvh, 0]
                    logit = np.where(valid, logit, ninf)
                    if logit.max() == ninf:
                        continue
                    m_new = max(m, logit.max())
                    alpha = np.exp(m - m_new)
                    p = np.where(valid, np.exp(logit - m_new), np.float32(0))
                    l = l * alpha + p.sum(dtype=np.float32)
                    if int8:
                        p = p * pages["vs"][page, keys, kvh, 0]
                    acc = acc * alpha + p @ vf[page, keys, kvh]
                    m = m_new
            part[bb, j, hh, sp] = (m, l, acc)
    out = np.zeros((b, kk, h, hd), np.float32)
    for bb in range(b):
        for j in range(kk):
            for hh in range(h):
                splits = [part[bb, j, hh, s] for s in range(plan.splits)]
                mx = max(s[0] for s in splits)
                lsum, o = np.float32(0), np.zeros(hd, np.float32)
                for ms, ls, acc in splits:            # in split order
                    # weight 0 for a split with no visible key (its l and
                    # acc are 0), never exp(-inf - -inf)
                    w = np.float32(0) if ms == ninf else np.exp(ms - mx)
                    lsum, o = lsum + w * ls, o + w * acc
                out[bb, j, hh] = o / lsum if lsum > 0 else 0
    return out.reshape(b, kk, h * hd)


@pytest.mark.parametrize("kk", [1, CHUNK], ids=["decode", "chunk"])
@pytest.mark.parametrize("head", list(HKV))
@pytest.mark.parametrize("dtype", list(ATOL))
def test_split_then_merge_matches_jax(dtype, head, kk):
    q, pages, table, positions = _case(11, dtype, HKV[head], kk)
    plan = paged_attention_plan(*q.shape[:3], HKV[head], HD, PS,
                                table.shape[1], TDT[dtype])
    assert plan.splits > 1          # the merge runs at these shapes
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
    jc = {n: jnp.asarray(a, jdt[dtype] if n in ("k", "v") else jnp.float32)
          for n, a in pages.items()}
    want = np.asarray(jax_paged_attend(jnp.asarray(q), jc,
                                       jnp.asarray(positions),
                                       jnp.asarray(table), PS))
    with np.errstate(invalid="ignore", over="ignore"):
        got = emulate(q, pages, positions, table, plan)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype],
                               err_msg=f"{dtype} {head} kk={kk}")

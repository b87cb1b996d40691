"""Paged attention read over one layer's page pools (counterpart of the
reference's `ops/pallas_paged_attention.py`).

`paged_attend` launches the hand-written CUDA kernel
`csrc/paged_attention.cu` for CUDA tensors and uses its plain PyTorch
version, `paged_attend_plain` (gather each slot's pages into
contiguous rows, then `attend_kv`: the oracle the reference's tests
use), for CPU tensors. There is no fallback from the kernel to the plain
version on the card.

`paged_attention_plan` is the kernel's launch geometry (rows per block,
the output columns' chunks, the split of each slot's pages across
blocks, copy widths, shared memory of its page ring, the splits'
scratch), computed on the host and handed to the C launch function,
which refuses any other. It takes every head dim the reference takes,
up to the one limit a page stage cannot avoid: one stage of a page's
whole key rows and its value rows' chunk must fit in a block's shared
memory (`max_head_dim`).

Shapes: q (B, kk, H, hd); the layer's page dict c holds k/v
(P, ps, Hkv, hd) in float32, bfloat16 or int8 (+ float32 scales ks/vs
(P, ps, Hkv, 1) for int8); positions (B, kk) int32; block_table
(B, npages) int32. Row j of slot b attends key positions <=
positions[b, j]. Returns (B, kk, H*hd) float32. While a step is
counted (`obs/cost.py`), a launch adds its nominal work
(`paged_attention_flops`) to the open counter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.generate import attend_kv
from ..obs import cost as _cost
from . import _kernels
from .kernel_ops import _counter_buffer

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_COLS = 256                  # output columns of a block (a chunk)
_MAX_WARPS = 8               # query rows of a block, one warp each
_TARGET_BLOCKS = 2 * 132     # two blocks per SM of the H100
_MAX_SPLITS = 16             # the merge holds every split's m and l
_STAGES = 2                  # the kernel's ring: one page in flight, or
                             # one stage where two do not fit
_SMEM_LIMIT = 226 * 1024     # a block's dynamic shared memory, below 227 KB


class PagedPlan(NamedTuple):
    """The paged read's launch: `grid` blocks of `threads` (`warps` warps,
    one query row each; a (slot, kv head)'s g * kk rows in `row_groups`
    groups), each block one (slot, kv head, row group, chunk, split), the
    split fastest. Chunk c holds output columns [256 c, 256 (c + 1)) of
    the head dim (one chunk up to 256), and each chunk's block computes
    the logits over the whole head dim. Split s folds pages
    [s * pages_per_split, (s + 1) * pages_per_split) of the block table,
    as far as its rows can see, `stages` pages in a ring (2: one in
    flight) copied `copy_bytes` at a time (`cp.async` at 16, 8 or 4;
    plain loads at 2 or 1, where a pool row is not 4-byte aligned). With
    splits > 1 the partials go to a float32 `scratch` of shape
    (B, kk, H, splits, chunks * (2 + the chunk width rounded up to
    even)) and the last block of each of the `counters` tiles (slot, kv
    head, row group, chunk) merges them; else both are None / 0."""
    warps: int
    row_groups: int
    splits: int
    pages_per_split: int
    copy_bytes: int
    grid: int
    threads: int
    smem_bytes: int
    scratch: tuple[int, ...] | None
    counters: int
    chunks: int = 1
    stages: int = _STAGES


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _stage_bytes(hd: int, ps: int, dtype: torch.dtype) -> int:
    """One stage of the ring: a page's key rows (whole) and value rows
    (one chunk's columns), each row rounded to 16 bytes plus 16, and for
    int8 their scales."""
    elem = _ELEM[dtype]
    cw = min(hd, _COLS)
    return _round16(ps * (_round16(hd * elem) + _round16(cw * elem) + 32)
                    + (8 * ps if dtype == torch.int8 else 0))


def _fixed_bytes(hd: int, pps: int, warps: int) -> int:
    """The block-table slice and the rows' q (rows of hd rounded up to
    4 floats)."""
    return _round16(4 * pps) + 4 * warps * (-(-hd // 4) * 4)


def max_head_dim(ps: int, dtype: torch.dtype, warps: int = _MAX_WARPS,
                 pps: int = 1) -> int:
    """The largest head dim whose single-stage ring fits in a block's
    shared memory (the plan's one refusal besides the reference's H %
    Hkv), at page size `ps`, `warps` query rows and `pps` pages a split."""
    lo, hi = 1, 1
    while _fixed_bytes(hi, pps, warps) + _stage_bytes(hi, ps, dtype) \
            <= _SMEM_LIMIT:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _fixed_bytes(mid, pps, warps) + _stage_bytes(mid, ps, dtype) \
                <= _SMEM_LIMIT:
            lo = mid
        else:
            hi = mid
    return lo


def paged_attention_plan(b: int, kk: int, h: int, hkv: int, hd: int, ps: int,
                         npages: int, dtype: torch.dtype) -> PagedPlan:
    """The launch plan of `csrc/paged_attention.cu` for q (b, kk, h, hd)
    over pages (P, ps, hkv, hd) of `dtype` through a (b, npages) block
    table, as the C launch function checks it.

    The split count fills the card: about `_TARGET_BLOCKS` blocks over the
    b * hkv * row_groups * chunks tiles, at most one per page and
    `_MAX_SPLITS`. Shared memory: the split's block-table entries, the
    rows' q (float32) and two stages of a key page, a value page's chunk
    (rows padded to 16 bytes, plus 16) and, for int8, their scales; one
    stage where two do not fit. Refused: H % Hkv, and a head dim whose one
    stage does not fit (`max_head_dim`)."""
    if dtype not in _ELEM:
        raise ValueError(f"paged_attention_plan: pages of {dtype}")
    if min(b, kk, hkv, ps, npages, hd) < 1 or h % hkv:
        raise ValueError(f"paged_attention_plan: B {b}, kk {kk}, {h} query "
                         f"heads over {hkv}, head dim {hd}, page {ps}, "
                         f"{npages} pages")
    elem = _ELEM[dtype]
    rows = (h // hkv) * kk
    warps = min(_MAX_WARPS, rows)
    row_groups = -(-rows // warps)
    chunks = -(-hd // _COLS)
    tiles = b * hkv * row_groups * chunks
    want = max(1, min(npages, _MAX_SPLITS, -(-_TARGET_BLOCKS // tiles)))
    pps = -(-npages // want)
    splits = -(-npages // pps)
    row_bytes = hd * elem
    copy_bytes = next(c for c in (16, 8, 4, 2, 1) if row_bytes % c == 0)
    fixed, stage = _fixed_bytes(hd, pps, warps), _stage_bytes(hd, ps, dtype)
    stages = next((n for n in (_STAGES, 1) if fixed + n * stage
                   <= _SMEM_LIMIT), 0)
    if not stages:
        raise ValueError(
            f"paged_attention_plan: one page of {ps} x {hd} {dtype} keys "
            f"and values does not fit in {_SMEM_LIMIT} bytes (head dim at "
            f"most {max_head_dim(ps, dtype, warps, pps)} here)")
    ent = 2 + -(-min(hd, _COLS) // 2) * 2
    scratch = (b, kk, h, splits, chunks * ent) if splits > 1 else None
    return PagedPlan(warps, row_groups, splits, pps, copy_bytes,
                     tiles * splits, 32 * warps, fixed + stages * stage,
                     scratch, tiles if splits > 1 else 0, chunks, stages)


def paged_attention_flops(b: int, kk: int, h: int, hd: int,
                          keys: int) -> int:
    """K1's nominal work (`obs/cost.py`): q k^T and p v over every key of
    the block table's extent (`keys` = npages * page_size), masked or
    not, as FlopCounterMode counts `paged_attend_plain`."""
    return 2 * 2 * b * kk * h * keys * hd


def paged_attend_plain(q: torch.Tensor, c: dict, positions: torch.Tensor,
                       block_table: torch.Tensor,
                       page_size: int) -> torch.Tensor:
    """Gather + attend_kv over the full block-table extent L = npages *
    page_size (the reference's semantics: keys past a row's position are
    masked with NEG_INF)."""
    b = block_table.shape[0]
    npages = block_table.shape[1]
    tbl = block_table.long()
    gathered = {name: c[name][tbl].reshape(b, npages * page_size,
                                           *c[name].shape[2:])
                for name in c}
    keys = torch.arange(npages * page_size, device=q.device)
    mask = keys[None, None, :] <= positions[:, :, None].long()
    return attend_kv(q, gathered["k"], gathered["v"], mask,
                     cks=gathered.get("ks"), cvs=gathered.get("vs"))


def paged_attend(q: torch.Tensor, c: dict, positions: torch.Tensor,
                 block_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """The paged read: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return paged_attend_plain(q, c, positions, block_table, page_size)
    b, kk, h, hd = q.shape
    k, v = c["k"], c["v"]
    num_pages, ps, hkv, khd = k.shape
    if ps != page_size or khd != hd or v.shape != k.shape:
        raise ValueError(f"paged_attend: pages {tuple(k.shape)}/"
                         f"{tuple(v.shape)} vs q {tuple(q.shape)}, "
                         f"page_size {page_size}")
    if h % hkv:
        raise ValueError(f"paged_attend: {h} query heads over {hkv} kv heads")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or positions.shape != (b, kk):
        raise ValueError(f"paged_attend: block table "
                         f"{tuple(block_table.shape)}, positions "
                         f"{tuple(positions.shape)} vs q {tuple(q.shape)}")
    code = _DTYPE_CODES.get(k.dtype)
    if (q.dtype != torch.float32 or code is None or v.dtype != k.dtype
            or block_table.dtype != torch.int32
            or positions.dtype != torch.int32):
        raise TypeError(f"paged_attend wants float32 q, float32/bf16/int8 "
                        f"pages, int32 table and positions; got {q.dtype}, "
                        f"{k.dtype}/{v.dtype}, {block_table.dtype}, "
                        f"{positions.dtype}")
    tensors = [q, k, v, block_table, positions]
    ks = vs = None
    if code == 2:
        ks, vs = c["ks"], c["vs"]
        if ks.shape != (num_pages, ps, hkv, 1) or vs.shape != ks.shape \
                or ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise ValueError("paged_attend: int8 pages need float32 ks/vs "
                             f"of shape {(num_pages, ps, hkv, 1)}")
        tensors += [ks, vs]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attend: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attend: all tensors must be contiguous")
    npages = block_table.shape[1]
    plan = paged_attention_plan(b, kk, h, hkv, hd, ps, npages, k.dtype)
    if k.data_ptr() % plan.copy_bytes or v.data_ptr() % plan.copy_bytes:
        raise ValueError(f"paged_attend: pages must be {plan.copy_bytes}-byte "
                         "aligned for the kernel's copies")
    out = torch.empty((b, kk, h * hd), dtype=torch.float32, device=q.device)
    part = (None if plan.scratch is None else
            torch.empty(plan.scratch, dtype=torch.float32, device=q.device))
    counters = (_counter_buffer("paged_attention", q.device, plan.counters)
                if plan.counters else None)
    err = _kernels.lib("paged_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, kk, h, hkv, hd, ps, npages, code, plan.warps, plan.row_groups,
        plan.chunks, plan.splits, plan.pages_per_split, plan.copy_bytes,
        plan.stages, plan.grid, plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("paged_attention", err)
    _kernels.launches["paged_attention"] += 1
    if _cost.OPEN is not None:
        pages = b * npages * ps * hkv * (hd * k.element_size()
                                         + (8 if code == 2 else 0))
        _cost.OPEN.kernel(paged_attention_flops(b, kk, h, hd, npages * ps),
                          q, block_table, positions, out, nbytes=2 * pages)
    return out

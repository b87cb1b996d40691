"""Paged attention read over one layer's page pools (counterpart of the
reference's `ops/pallas_paged_attention.py`).

`paged_attend` launches the hand-written CUDA kernel
`csrc/paged_attention.cu` for CUDA tensors and uses its plain PyTorch
version, `paged_attend_plain` (gather each slot's pages into
contiguous rows, then `attend_kv`: the oracle the reference's tests
use), for CPU tensors. There is no fallback from the kernel to the plain
version on the card.

Shapes: q (B, kk, H, hd); the layer's page dict c holds k/v
(P, ps, Hkv, hd) in float32, bfloat16 or int8 (+ float32 scales ks/vs
(P, ps, Hkv, 1) for int8); positions (B, kk) int32; block_table
(B, npages) int32. Row j of slot b attends key positions <=
positions[b, j]. Returns (B, kk, H*hd) float32.
"""

from __future__ import annotations

import torch

from ..models.generate import attend_kv
from . import _kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    if h % hkv or hd > 256:
        raise ValueError(f"paged_attend: {h} query heads over {hkv} kv "
                         f"heads, head dim {hd} (max 256)")
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
    out = torch.empty((b, kk, h * hd), dtype=torch.float32, device=q.device)
    warps = min(8, (h // hkv) * kk)
    err = _kernels.lib("paged_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        b, kk, h, hkv, hd, ps, block_table.shape[1], code, warps,
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("paged_attention", err)
    _kernels.launches["paged_attention"] += 1
    return out

"""Paged KV cache: per-layer page pools + per-slot block tables
(counterpart of the reference's `serve/paged_cache.py`).

- per layer, `k`/`v` pools of shape (num_pages, page_size, Hkv, hd)
  (+ float32 absmax scales (num_pages, page_size, Hkv, 1) for int8);
- a per-slot block table (slots, pages_per_slot) of page indices maps a
  sequence's position p to page block_table[s, p // page_size] at offset
  p % page_size;
- page 0 is the reserved scratch page: every write from a dead slot or a
  padding token goes there, so it never touches a live sequence's page.

The reference's jitted programs donate the pools and get them back
updated; here the scatter write updates the pools IN PLACE, which is
what that donation achieves. The attention read is `kernel`'s: "gather"
(gather each slot's pages, then the shared `attend_kv`, always in plain
PyTorch) or "cuda" (`ops/paged_attention.paged_attend`: the CUDA kernel
for tensors on the card).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..models.generate import _quant_kv, token_forward
from ..models.transformer import TransformerLM
from ..ops.paged_attention import paged_attend, paged_attend_plain
from .pool import pages_for

KERNELS = ("gather", "cuda")


@dataclasses.dataclass
class PagedKVCache:
    """Device-side paged cache state: per-layer page pools + the block
    table, the attention read to use ("gather" or "cuda"), and the int8
    page write's quantizer (x -> (int8 codes, float32 scales); a check
    may put a recording one in its place)."""

    pages: list[dict]
    block_table: torch.Tensor      # (slots, pages_per_slot) int32
    page_size: int
    kernel: str = "gather"
    quant: Callable = _quant_kv

    @property
    def num_pages(self) -> int:
        return self.pages[0]["k"].shape[0]

    @property
    def slots(self) -> int:
        return self.block_table.shape[0]


def init_paged_cache(model: TransformerLM, *, slots: int, num_pages: int,
                     page_size: int, dtype=torch.float32,
                     max_len: int | None = None, kernel: str = "gather",
                     device: torch.device | str = "cpu") -> PagedKVCache:
    """Empty page pools + an all-scratch block table. num_pages INCLUDES
    the scratch page 0; max_len (default model.max_seq) fixes the block
    table's width."""
    if num_pages < 2:
        raise ValueError(f"num_pages {num_pages} < 2 (page 0 is scratch)")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}: want one of {KERNELS}")
    max_len = max_len or model.max_seq
    shape = (num_pages, page_size, model.n_kv, model.head_dim)
    sshape = shape[:-1] + (1,)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    pages = []
    for _ in range(model.depth):
        if dtype == torch.int8:
            pages.append({"k": zeros(shape, torch.int8),
                          "ks": zeros(sshape, torch.float32),
                          "v": zeros(shape, torch.int8),
                          "vs": zeros(sshape, torch.float32)})
        else:
            pages.append({"k": zeros(shape, dtype), "v": zeros(shape, dtype)})
    table = zeros((slots, pages_for(max_len, page_size)), torch.int32)
    return PagedKVCache(pages=pages, block_table=table, page_size=page_size,
                        kernel=kernel)


def paged_update_attend(c: dict, q, k, v, positions, valid, block_table,
                        page_size: int, kernel: str = "gather",
                        quant: Callable = _quant_kv):
    """One layer's paged write + attention read.

    q: (B, kk, H, hd); k/v: (B, kk, Hkv, hd); positions: (B, kk) int32
    absolute positions; valid: (B, kk) bool — invalid tokens (padding,
    dead slots) write to scratch page 0 at offset 0. Writes land first
    (in-chunk causality), in place in `c`, int8 pages through `quant`;
    then the read runs per `kernel`. Returns (o: (B, kk, H*hd) float32, c)."""
    b, kk = positions.shape
    hkv, hd = k.shape[2], k.shape[3]
    npages = block_table.shape[1]
    pos = positions.long()
    # Padding rows of a prefill chunk may sit past the table's extent;
    # they are invalid and go to scratch, but the lookup must stay in
    # range (the reference's gather clamps the same way).
    col = torch.clamp(pos // page_size, max=npages - 1)
    page_idx = torch.gather(block_table.long(), 1, col)
    zero = torch.zeros_like(page_idx)
    pi = torch.where(valid, page_idx, zero).reshape(-1)
    of = torch.where(valid, pos % page_size, zero).reshape(-1)
    if c["k"].dtype == torch.int8:
        qk8, sk8 = quant(k)
        qv8, sv8 = quant(v)
        c["k"][pi, of] = qk8.reshape(b * kk, hkv, hd)
        c["ks"][pi, of] = sk8.reshape(b * kk, hkv, 1)
        c["v"][pi, of] = qv8.reshape(b * kk, hkv, hd)
        c["vs"][pi, of] = sv8.reshape(b * kk, hkv, 1)
    else:
        cdt = c["k"].dtype
        c["k"][pi, of] = k.to(cdt).reshape(b * kk, hkv, hd)
        c["v"][pi, of] = v.to(cdt).reshape(b * kk, hkv, hd)
    if kernel == "cuda":
        o = paged_attend(q.to(torch.float32).contiguous(), c, positions,
                         block_table, page_size)
    else:
        o = paged_attend_plain(q, c, positions, block_table, page_size)
    return o, c


def paged_forward(model: TransformerLM, params: dict, toks, positions, valid,
                  cache: PagedKVCache):
    """toks (B, kk) through the model against the paged cache (the
    pools update in place). positions: (B, kk) int32; valid: (B, kk)
    bool. Returns (logits (B, kk, vocab) float32, cache)."""

    def attend(i, q, k, v):
        o, _ = paged_update_attend(
            cache.pages[i], q, k, v, positions, valid, cache.block_table,
            cache.page_size, kernel=cache.kernel, quant=cache.quant,
        )
        return o

    return token_forward(model, params, toks, positions, attend), cache

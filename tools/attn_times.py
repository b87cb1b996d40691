#!/usr/bin/env python3
"""Device times of the float32 flash forward (K7) and the paged-attention
read (K1) at `chip_smoke.py`'s shapes, for the checkout it is run from:
it imports that checkout's `chip_smoke.py` and port, so it times another
commit's kernels when run from an unpacked copy of it.

- K7 float32 at chip_smoke's float32 flash shapes (the LM flagship B 8,
  S 2048, H 8, D 64 and GQA B 2, 8/2 heads, causal; B 2, S 1024, 4/2
  heads at D 32 and D 128 causal and D 64 non-causal), with SDPA's
  float32 forward on the same inputs beside it; the largest error and
  the relative L2 error against the plain version beside each time.
- K1 at chip_smoke's six serving cases (float32, bf16 and int8 pages;
  decode B 8, kk 1 and the prefill chunk B 1, kk 32; 8 query over 2 kv
  heads, hd 64, pages of 16, a table of 80 pages) and at the serve
  phase's own geometry (int8 pages, a table of pages_for(max_seq) = 128
  pages, positions in its requests' range), inputs made here from a
  seed as `chip_smoke.attention_case` makes them.

Each time is `chip_smoke.median_ms` (median of 30 launches, CUDA
events). One line per shape, tagged; then, unless `--no-profile`, that
checkout's `chip_smoke.phase_lm_profile` (the LM flagship's f32 and bf16
flash steps under torch.profiler).

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/attn_times.py $t)
    done

Needs a CUDA device; it builds the two kernels of that checkout on first
use.
"""

from __future__ import annotations

import argparse
import os
import sys

def k1_cases(cs) -> list[tuple]:
    """(pages dtype, B, kk, table pages, (lo, hi) of the last position):
    chip_smoke's six cases at TABLE_PAGES, then the serve phase's int8
    decode and prefill chunk at its table width."""
    from mpi_cuda_cnn_tpu_torch.serve import bench as serve_bench
    from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for

    big = cs.TABLE_PAGES * cs.PAGE
    cases = [(dtype, b, kk, cs.TABLE_PAGES, (big // 2, big - 1))
             for dtype in ("float32", "bfloat16", "int8")
             for b, kk in ((8, 1), (1, 32))]
    a = serve_bench._parser().parse_args(cs.SERVE_ARGS)
    span = (a.prompt_min, a.prompt_max + a.out_max)
    return cases + [("int8", b, kk, pages_for(a.max_seq, a.page_size), span)
                    for b, kk in ((a.slots, 1), (1, a.prefill_chunk))]


def k1_inputs(torch, cs, dev, dtype: str, b: int, kk: int, pages: int,
              span: tuple[int, int], gen):
    """Pages, table, positions and q as chip_smoke.attention_case makes
    them: a pool of b * pages + 1 pages, distinct random tables,
    positions that end mid-page in [span)."""
    from mpi_cuda_cnn_tpu_torch.models.generate import _quant_kv

    pool = b * pages + 1
    shape = (pool, cs.PAGE, cs.KV_HEADS, cs.HEAD_DIM)

    def randn(*s):
        return torch.randn(*s, generator=gen).to(dev)

    if dtype == "int8":
        k8, ks = _quant_kv(randn(*shape))
        v8, vs = _quant_kv(randn(*shape))
        c = {"k": k8, "ks": ks, "v": v8, "vs": vs}
    else:
        tdt = getattr(torch, dtype)
        c = {"k": randn(*shape).to(tdt), "v": randn(*shape).to(tdt)}
    perm = torch.randperm(pool - 1, generator=gen)[: b * pages] + 1
    table = perm.reshape(b, pages).to(torch.int32).to(dev)
    last = torch.randint(*span, (b, 1), generator=gen)
    last = torch.where(last % cs.PAGE == cs.PAGE - 1, last - 1, last)
    positions = (last - kk + 1 + torch.arange(kk)[None, :]).to(torch.int32)
    q = randn(b, kk, cs.HEADS, cs.HEAD_DIM)
    return q, c, positions.to(dev), table


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tag", nargs="?", default=os.path.basename(os.getcwd()))
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
    from mpi_cuda_cnn_tpu_torch.ops.paged_attention import (
        paged_attend,
        paged_attend_plain,
    )

    if not torch.cuda.is_available():
        print("attn_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    F = torch.nn.functional
    tag = args.tag
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    shapes = ([(*s, True) for dtype, *s in cs.FLASH_SHAPES if dtype == "float32"]
              + [tuple(s) for dtype, *s in cs.FLASH_EXTRA_SHAPES
                 if dtype == "float32"])
    for b, s, h, hkv, d, causal in shapes:
        q, k, v = (torch.randn(*sh, generator=gen).to(dev)
                   for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        want_o, want_lse = fa.flash_forward_plain(q, k, v, causal)
        o, lse = fa.flash_forward(q, k, v, causal)
        err = max((o - want_o).abs().max().item(),
                  (lse - want_lse).abs().max().item())
        rel = cs.rel_l2(o, want_o, per_row=False)
        ms = cs.median_ms(torch, lambda: fa.flash_forward(q, k, v, causal))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with torch.no_grad():
            sdpa = cs.median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=hkv != h))
        print(f"{tag} K7 float32 B{b} S{s} H{h}/{hkv} D{d} causal={int(causal)} "
              f"fwd_ms {ms:.4f} err {err:.2e} rel_l2 {rel:.2e} "
              f"sdpa_fwd_ms {sdpa:.4f}", flush=True)
    for dtype, b, kk, pages, span in k1_cases(cs):
        q, c, positions, table = k1_inputs(torch, cs, dev, dtype, b, kk,
                                           pages, span, gen)
        err = (paged_attend(q, c, positions, table, cs.PAGE)
               - paged_attend_plain(q, c, positions, table, cs.PAGE)
               ).abs().max().item()
        ms = cs.median_ms(torch, lambda: paged_attend(q, c, positions, table,
                                                      cs.PAGE))
        print(f"{tag} K1 {dtype} B{b} kk{kk} L{pages * cs.PAGE} "
              f"ms {ms:.4f} err {err:.2e}", flush=True)
    if not args.no_profile:
        cs.phase_lm_profile(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device times of the flash backward kernels, K8 (dq) and K9 (dk/dv), in
float32 and bf16, at `chip_smoke.py`'s flash shapes (the LM flagship B 8,
S 2048, H 8, D 64 and GQA B 2, 8/2 heads, causal; then B 2, S 1024, 4/2
heads at D 32 and D 128 causal and D 64 non-causal), with SDPA's backward
alone on the same inputs beside them, for the checkout it is run from: it
imports that checkout's `chip_smoke.py` and port, so it times another
commit's kernels when run from an unpacked copy of it. Each time is
`chip_smoke.median_ms` (median of 30 launches, CUDA events). One line per
shape and type, tagged; then that checkout's `chip_smoke.phase_lm_profile`
(the LM flagship's f32 and bf16 flash steps under torch.profiler: step
ms, device busy ms, the flash kernels' ms), one JSON line each.

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/flash_bwd_times.py $t)
    done

Needs a CUDA device; it builds the flash kernels of that checkout on
first use.
"""

from __future__ import annotations

import os
import sys

# (B, S, H, Hkv, D, causal) beyond chip_smoke.FLASH_SHAPES, in both types.
EXTRA_SHAPES = [(2, 1024, 4, 2, 32, True), (2, 1024, 4, 2, 128, True),
                (2, 1024, 4, 2, 64, False)]


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    shapes = ([(dtype, *s, True) for dtype, *s in cs.FLASH_SHAPES]
              + [(dtype, *s) for dtype in ("float32", "bfloat16")
                 for s in EXTRA_SHAPES])
    for dtype, b, s, h, hkv, d, causal in shapes:
        tdt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(*shape, generator=gen).to(dev).to(tdt)

        q, k, v, g = randn(b, s, h, d), randn(b, s, hkv, d), \
            randn(b, s, hkv, d), randn(b, s, h, d)
        o, lse = fa.flash_forward_plain(q, k, v, causal)
        dvec = fa.row_dvec(o, g)
        dq = cs.median_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, g, lse,
                                                         dvec, causal))
        dkv = cs.median_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, g, lse,
                                                           dvec, causal))
        sdpa = cs.sdpa_ms(torch, q, k, v, g, causal)["library_bwd_ms"]
        print(f"{tag} {dtype} B{b} S{s} H{h}/{hkv} D{d} causal={int(causal)} "
              f"dq_ms {dq:.4f} dkv_ms {dkv:.4f} sdpa_bwd_ms {sdpa:.4f}",
              flush=True)
    cs.phase_lm_profile(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

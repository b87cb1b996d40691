#!/usr/bin/env python3
"""Device times of the bf16 flash backward kernels, K8 (dq) and K9 (dk/dv),
at `chip_smoke.py`'s bf16 flash shapes (the LM flagship, GQA 8/2, D 32,
D 128, non-causal D 64), for the checkout it is run from: it imports that
checkout's `chip_smoke.py` and port, so it times another commit's kernels
when run from an unpacked copy of it. Each time is `chip_smoke.median_ms`
(median of 30 launches, CUDA events). One line per shape, tagged.

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
    shapes = ([(*s, True) for s in cs.FLASH_SHAPES if s[0] == "bfloat16"]
              + cs.FLASH_EXTRA_SHAPES)
    for _, b, s, h, hkv, d, causal in shapes:
        def randn(*shape):
            return torch.randn(*shape, generator=gen).to(dev).to(torch.bfloat16)

        q, k, v, g = randn(b, s, h, d), randn(b, s, hkv, d), \
            randn(b, s, hkv, d), randn(b, s, h, d)
        o, lse = fa.flash_forward_plain(q, k, v, causal)
        dvec = fa.row_dvec(o, g)
        dq = cs.median_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, g, lse,
                                                         dvec, causal))
        dkv = cs.median_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, g, lse,
                                                           dvec, causal))
        print(f"{tag} B{b} S{s} H{h}/{hkv} D{d} causal={int(causal)} "
              f"dq_ms {dq:.4f} dkv_ms {dkv:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

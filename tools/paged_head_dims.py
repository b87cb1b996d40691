#!/usr/bin/env python3
"""The paged-attention kernel K1 at the head dims beyond its first
instance's, on the card: builds K1 (one `nvcc`) and prints its
registers and spill bytes from the ptxas report; then holds the kernel
to its plain version (`chip_smoke.attention_case`: its tolerances, the
two runs equal bit for bit, its times, bound and SDPA's time) at D in
`CHECK_DIMS` (not a multiple of 4, odd: an odd last value column, 2- and
1-byte page copies and the unaligned output store, not a multiple of 8,
above 256 in column chunks, odd there too) in
float32, bf16 and int8 pages, at decode (B 8, kk 1) and at a prefill
chunk (B 1, kk 32), over the serve flagship's 8 query / 2 kv heads and
a table of 80 pages of 16; and at D 2232 float32, the largest the plan
takes at page 16 (one page in the ring, `paged_attention.max_head_dim`).

One JSON line per case (`{"case": ...}`, or `{"failed": ...}` with the
error), then a summary line `{"cases": N, "failed": [...]}`. Exit 1 when
any case failed. Run from the repository root on a machine with a card:

    python3 tools/paged_head_dims.py
"""

from __future__ import annotations

import json
import os
import sys
import time

CHECK_DIMS = (6, 7, 9, 10, 20, 320, 321, 512)
DTYPES = ("float32", "bfloat16", "int8")
ROWS = ((8, 1), (1, 32))          # (B, kk): decode, a prefill chunk
LARGEST = ("float32", 8, 1, 2232)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("paged_head_dims: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    print(json.dumps({"device": cs.nvidia_smi()}), flush=True)
    t0 = time.perf_counter()
    job = _kernels._start_build("paged_attention")
    log = (_kernels._finish_build("paged_attention", *job) if job is not None
           else _kernels._kept_log("paged_attention"))
    print(json.dumps({"build": "paged_attention",
                      "seconds": time.perf_counter() - t0,
                      "registers": cs.registers(log),
                      "spill_bytes": cs.spill_stores(log)}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    cases = [(dtype, b, kk, d) for d in CHECK_DIMS for dtype in DTYPES
             for b, kk in ROWS] + [LARGEST]
    failed = []
    for dtype, b, kk, d in cases:
        try:
            case = cs.attention_case(torch, dev, dtype, b, kk, gen,
                                     head_dim=d)
            print(json.dumps({"case": case}), flush=True)
        except Exception as e:  # noqa: BLE001 (every case is reported)
            failed.append(f"{dtype} B{b} kk{kk} D{d}")
            print(json.dumps({"failed": failed[-1], "error": repr(e)}),
                  flush=True)
    print(json.dumps({"cases": len(cases), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

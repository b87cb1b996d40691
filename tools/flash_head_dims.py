#!/usr/bin/env python3
"""The flash kernels K7, K8 and K9 at every head-dim instance and at padded
head dims, on the card: builds the three flash libraries (one `nvcc` each,
started together) and prints each kernel instance's registers and spill
bytes from the ptxas report; then holds every kernel to its plain version
(`chip_smoke.flash_cases`, its tolerances) at D in `CHECK_DIMS` (the
instances 16, 32, 64, 80, 96, 128, 256 and the padded 24, 48, 200), both
types, causal and not, MHA 4/4 and GQA 8/2, B 2, S 256, and the bf16
float32-output mode (ring-flash's) at D 80 and 256, causal and not, GQA
8/2 (`--dims` replaces both lists, e.g. with the wide head dims 300,320,
512); then, with --times, the D 80 and D 96
flagship geometry (B 8, S 2048, 8 heads, causal) and D 48 beside D 64 (the
padding's cost) at 30 calls with their bound and SDPA's times.

One JSON line per case (`{"case": ...}`, or `{"failed": ...}` with the
error), also appended to the file `--out` names, then a summary line
`{"cases": N, "failed": [...], ...}`. Exit 1 when any case failed. Run
from the repository root on a machine with a card (about 2 minutes):

    python3 tools/flash_head_dims.py --times --out flash_head_dims.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CHECK_DIMS = (16, 24, 32, 48, 64, 80, 96, 128, 200, 256)
F32_OUT_DIMS = (80, 256)
TIMED = [(dtype, 8, 2048, 8, hkv, d) for d in (80, 96, 48, 64)
         for dtype in ("float32", "bfloat16") for hkv in (8,)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--out", default=None, help="a JSONL copy of the lines")
    ap.add_argument("--dims", default=None,
                    help="comma-separated head dims in place of CHECK_DIMS "
                         "(and of F32_OUT_DIMS), e.g. the wide 300,320,512")
    args = ap.parse_args()
    check_dims, f32_out_dims = CHECK_DIMS, F32_OUT_DIMS
    if args.dims:
        check_dims = f32_out_dims = tuple(int(x) for x in args.dims.split(","))
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("flash_head_dims: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    out = open(args.out, "a") if args.out else None

    def emit(obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    emit({"device": cs.nvidia_smi()})
    t0 = time.perf_counter()
    jobs = {n: _kernels._start_build(n) for n in cs.FLASH_KERNELS}
    logs = {n: (_kernels._finish_build(n, *j) if j is not None
                else _kernels._kept_log(n)) for n, j in jobs.items()}
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        emit({"build": name, "seconds": build_s,
              "registers": cs.registers(log),
              "spill_bytes": cs.spill_stores(log)})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    n, failed = 0, []
    shapes = [(dtype, 2, 256, h, hkv, d, causal, False)
              for d in check_dims for dtype in ("float32", "bfloat16")
              for h, hkv in ((4, 4), (8, 2)) for causal in (True, False)]
    shapes += [("bfloat16", 2, 256, 8, 2, d, causal, True)
               for d in f32_out_dims for causal in (True, False)]
    if args.times:
        shapes += [(*s, True, False) for s in TIMED]
    for dtype, b, s, h, hkv, d, causal, f32_out in shapes:
        reps = 30 if b == 8 else 3
        try:
            cases = cs.flash_cases(torch, dev, dtype, b, s, h, hkv, d, gen,
                                   causal, f32_out, reps)
        except Exception as e:  # noqa: BLE001 — report every case
            failed.append({"shape": [dtype, b, s, h, hkv, d, causal,
                                     f32_out],
                           "error": f"{type(e).__name__}: {e}"[:600]})
            emit({"failed": failed[-1]})
            continue
        for c in cases:
            n += 1
            keep = {k: c[k] for k in ("kernel", "dtype", "B", "S", "H", "Hkv",
                                      "D", "causal", "max_abs_err",
                                      "tolerance", "rel_l2_err", "ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "library_fwd_bwd_ms",
                                      "library_bwd_ms") if k in c}
            emit({"case": keep, **({"f32_out": True} if f32_out else {})})
    emit({"cases": n, "failed": failed, "build_s": build_s,
          "seconds": time.perf_counter() - t0})
    if out is not None:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

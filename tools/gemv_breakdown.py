#!/usr/bin/env python3
"""Where the int8 weight matmul K2's time goes: device times at the serve
phase's ten products (as `tools/gemv_times.py`) of `csrc/int8_gemm.cu`
and of copies of it, three with one phase taken out and one with the
shared memory moved:

- no_copies: the slab's copies of q and x (the kernel computes on
  whatever shared memory holds);
- no_fma: the FMA loop;
- no_split_sum: everything after a split's partial is stored (the fence,
  the counter and the last block's split sum; y is left unwritten);
- smem_16: the dynamic shared memory aligned to 16 bytes instead of 128,
  which puts it 16 bytes past a 128-byte line, after the static flag.

The copies are built from the source by plain text edits (each edit must
apply once) with the flags `ops/_kernels.py` uses, into
build/gemv_breakdown/, and swapped in for the wrapper's launch function,
so the plan, the wrapper and the timing are the real ones. The full
kernel's and smem_16's results are checked against the plain version;
the others are wrong by design. Times are `chip_smoke.median_ms`, the variants run in
order and then in reverse, one tagged line each.

    python3 tools/gemv_breakdown.py

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

DIM, VOCAB, KV = 512, 8192, 256
SHAPES = [(n, din, dout) for n in (8, 32)
          for din, dout in ((DIM, DIM), (DIM, KV), (DIM, 4 * DIM),
                            (4 * DIM, DIM), (DIM, VOCAB))]
# variant -> [(text in csrc/int8_gemm.cu, its replacement), ...]
EDITS = {
    "no_copies": [("  if (g.q_vec == 1) {\n    for (int e = tid;",
                   "  if (0) {\n  } else if (0) {\n    for (int e = tid;"),
                  ("  {\n    const int per = g.x_vec / 4;",
                   "  if (0) {\n    const int per = g.x_vec / 4;")],
    "no_fma": [("for (int gi = kl; gi < groups; gi += g.k_lanes) {",
                "for (int gi = kl; gi < 0; gi += g.k_lanes) {")],
    "no_split_sum": [("  __threadfence();  // this block's partial",
                      "  return;\n  __threadfence();  // this block's partial"
                      )],
    "smem_16": [("extern __shared__ __align__(128)",
                 "extern __shared__ __align__(16)")],
}


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels, gemv

    if not torch.cuda.is_available():
        print("gemv_breakdown: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    print(cs.nvidia_smi(), flush=True)
    src = (_kernels.CSRC / "int8_gemm.cu").read_text()
    out = root / "build" / "gemv_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    fns = {"full": _kernels.lib("int8_gemm")}
    jobs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"gemv_breakdown: {name}: an edit does not "
                                 f"apply once to csrc/int8_gemm.cu")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(out / f"lib{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"gemv_breakdown: nvcc {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")),
                     _kernels.KERNELS["int8_gemm"][0])
        fn.argtypes = _kernels.KERNELS["int8_gemm"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    data = []
    for n, din, dout in SHAPES:
        w = gemv.quantize_weight((torch.randn(din, dout, generator=gen)
                                  / din ** 0.5).to(dev))
        x = torch.randn(n, din, generator=gen).to(dev)
        data.append((n, din, dout, x, w))
    order = list(fns)
    try:
        for name in order + order[::-1]:
            _kernels._fns["int8_gemm"] = fns[name]
            for n, din, dout, x, w in data:
                if name in ("full", "smem_16"):
                    want = gemv.int8_gemv_plain(x, w)
                    err = (gemv.int8_gemv(x, w) - want).abs().max().item()
                    assert err <= cs.GEMM_RTOL_OF_MAX * want.abs().max().item()
                ms = cs.median_ms(torch, lambda: gemv.int8_gemv(x, w))
                print(f"{name} int8_gemm N {n} {din}x{dout} ms {ms:.4f}",
                      flush=True)
    finally:
        _kernels._fns["int8_gemm"] = fns["full"]
    return 0


if __name__ == "__main__":
    sys.exit(main())

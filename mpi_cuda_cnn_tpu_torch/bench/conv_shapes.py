"""`python -m mpi_cuda_cnn_tpu_torch conv-bench` — per-shape conv forward
times (counterpart of the reference's `scripts/bench_conv_shapes.py`).

For each of the reference's five shapes (four cifar3conv / vgg_small
layers at batch 128 and reference_cnn's conv1), in float32 then bf16, it
times three forms of the same conv forward with `utils.sync.two_point_ms`
(n = --iters calls against 2n, median of 3): PyTorch's own conv
(`ops/conv.conv2d`, cuDNN on the card with TF32 off; the oracle), the
direct kernel K4 (`kernel_ops.conv2d_kernel`) and the implicit-GEMM
kernel K6 (`kernel_ops.conv2d_gemm_kernel`; stride 1 only, so NaN on the
stride-2 row). Inputs are drawn by `np.random.default_rng(0)` in the
reference's order. Prints one line per row in the reference's format,
with the port's backend names:

    f32 128x32x32x64 k3 -> 64 s1: torch ... ms  cuda ... ms  gemm ... ms  ratio a/b

    python -m mpi_cuda_cnn_tpu_torch conv-bench [--iters 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np
import torch

# The reference's shapes (scripts/bench_conv_shapes.py:31-37):
# (n, h, w, cin, k, cout, stride, padding).
SHAPES = [
    (128, 32, 32, 3, 3, 64, 1, 1),
    (128, 32, 32, 64, 3, 64, 1, 1),
    (128, 16, 16, 64, 3, 128, 1, 1),
    (128, 8, 8, 128, 3, 256, 1, 1),
    (32, 28, 28, 1, 3, 16, 2, 1),
]
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch conv-bench",
        description="Per-shape conv forward times: PyTorch's conv, the "
                    "direct kernel and the implicit-GEMM kernel.")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def conv_bench(argv: list[str] | None = None) -> dict:
    """Run the bench and print its lines; return {"device": the device's
    name, "rows": one dict per line (shape, dtype, the three times, the
    kernel launches the row made)}. Raises RuntimeError without a card
    when the card is asked for."""
    from .._device import resolve_device
    from ..ops import _kernels
    from ..ops.conv import conv2d
    from ..ops.kernel_ops import conv2d_gemm_kernel, conv2d_kernel
    from ..utils.sync import two_point_ms

    args = _parser().parse_args(argv)
    if args.iters < 1:
        raise ValueError("--iters must be >= 1")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    rows = []
    with torch.no_grad():
        for dt_name, dtype in DTYPES:
            for (n, h, w, ci, k, co, s, p) in SHAPES:
                x = torch.from_numpy(rng.standard_normal((n, h, w, ci))).to(
                    device=dev, dtype=dtype)
                wt = torch.from_numpy(rng.standard_normal((k, k, ci, co))).to(
                    device=dev, dtype=dtype)
                before = dict(_kernels.launches)
                t_torch = two_point_ms(partial(conv2d, stride=s, padding=p),
                                       args.iters, x, wt)
                t_cuda = two_point_ms(
                    partial(conv2d_kernel, stride=s, padding=p), args.iters,
                    x, wt)
                t_gemm = (two_point_ms(
                    partial(conv2d_gemm_kernel, stride=s, padding=p),
                    args.iters, x, wt) if s == 1 else float("nan"))
                print(f"{dt_name} {n}x{h}x{w}x{ci} k{k} -> {co} s{s}: "
                      f"torch {t_torch:7.3f} ms  cuda {t_cuda:7.3f} ms  "
                      f"gemm {t_gemm:7.3f} ms  "
                      f"ratio {t_cuda / t_torch:5.2f}/{t_gemm / t_torch:5.2f}",
                      flush=True)
                rows.append({
                    "dtype": dt_name, "N": n, "H": h, "W": w, "C": ci, "k": k,
                    "O": co, "stride": s, "padding": p, "torch_ms": t_torch,
                    "cuda_ms": t_cuda, "gemm_ms": t_gemm,
                    "kernel_launches": {name: _kernels.launches[name] - before[name]
                                        for name in before}})
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": name, "iters": args.iters, "rows": rows}


def conv_bench_main(argv: list[str] | None = None) -> int:
    try:
        conv_bench(argv)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0

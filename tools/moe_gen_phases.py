#!/usr/bin/env python3
"""The MoE and generation phases of `chip_smoke.py` alone, on one card:

    python3 tools/moe_gen_phases.py

Builds every kernel, runs the kernel cases of generate's int8 products
(K2 at N 1 and 8) and of the MoE engine's MHA pages (K1), then
`chip_smoke.py`'s `lm` (the dense flagship the generate phase samples
from), `lm_moe` and `generate` phases, printing their lines. Each line
carries the card's name and power limit where chip_smoke's does. Run it
from the checkout's root; it exits non-zero when any check fails.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_gen_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()
    t0 = time.perf_counter()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": cs.nvidia_smi(), "torch": torch.__version__})
    built = _kernels.build_all()
    cs.emit({"phase": "build", "seconds": round(built["seconds"], 3)})
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    args = cs.serve_args()
    width = args.max_seq // args.page_size
    for n, din, dout in [(n, *s) for n in (1, cs.GEN_LOOKUP_K)
                         for s in cs.GEMM_GENERATE]:
        cs.emit({"phase": "kernel_case", "generate": True,
                 **cs.gemm_case(torch, dev, n, din, dout, gen)})
    span = (cs.GEN_SERVE["prompt_min"],
            cs.GEN_SERVE["prompt_max"] + cs.GEN_SERVE["out_max"])
    for b, kk in ((args.slots, 1), (1, args.prefill_chunk)):
        cs.emit({"phase": "kernel_case", "generate": True,
                 **cs.attention_case(torch, dev, "int8", b, kk, gen,
                                     pages=width, last_range=span,
                                     kv_heads=cs.HEADS)})
    _, lm_trainer = cs.phase_lm(torch)
    _, moe_trainer = cs.phase_lm_moe(torch)
    cs.emit({"phase": "generate_launches",
             **cs.phase_generate(torch, lm_trainer, moe_trainer)})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0,
             "nvidia_smi": cs.nvidia_smi()})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)

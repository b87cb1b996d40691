#!/usr/bin/env python3
"""The lm_mesh phase of `chip_smoke.py` alone, on one card:

    python3 tools/lm_mesh_phases.py [--nccl]

Builds K7, K8 and K9, runs `chip_smoke.py`'s flash kernel cases at the
shapes the phase launches them (`lm_mesh_shapes`: each rank's rows,
positions and heads), then its `lm_mesh` phase (the LM flagship's width
at 4 layers on TP, FSDP, PP, TP x SP, the 4D pipe x model x seq mesh,
EP x DP, EP x SP and FSDP x SP as gloo ranks on cuda:0, each run's first
gradients against its one-device reference and every rank's launches
against the plan), printing its lines. With `--nccl` and as many cards
as a world's ranks, each world also runs over NCCL, one rank a card.
Each line carries the seconds since the script started (`t_s`). Run it
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
        print("lm_mesh_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": smi, "count": torch.cuda.device_count(),
             "torch": torch.__version__})
    for name in cs.FLASH_KERNELS:
        _kernels.lib(name)
    cs.emit({"phase": "build", "kernels": list(cs.FLASH_KERNELS),
             "seconds": time.perf_counter() - t0})
    gen = torch.Generator().manual_seed(1)
    t_cases = time.perf_counter()
    n = 0
    for shape in cs.lm_mesh_shapes():
        *dims, causal = shape
        for case in cs.flash_cases(torch, torch.device("cuda"), *dims, gen,
                                   causal, reps=cs.MESH_CASE_REPS):
            cs.emit({"phase": "kernel_case", **case, "lm_mesh": True})
            n += 1
    cs.emit({"phase": "lm_mesh_kernel_cases", "cases": n,
             "seconds": time.perf_counter() - t_cases})
    mesh = cs.phase_lm_mesh(torch, nccl="--nccl" in sys.argv[1:])
    cs.emit({"phase": "lm_mesh_summary", "nvidia_smi": smi,
             **mesh["record"], "launches": mesh["launches"]})
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

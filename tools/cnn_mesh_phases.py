#!/usr/bin/env python3
"""The cnn_mesh phase of `chip_smoke.py` alone, on one card:

    python3 tools/cnn_mesh_phases.py

Builds K3, K4/K4' and K5, runs `chip_smoke.py`'s kernel cases at the
shapes the phase launches them (the `mesh` ones), then its `cnn_mesh` phase
(reference_cnn on TP, FSDP, PP, TP x PP and FSDP x PP meshes as gloo
ranks on cuda:0 against the one-device Trainer, launches and
collectives held to each mesh's plan, then the pipe:2 and
data:2,model:2 epochs and evals), printing its lines. Each line carries
the seconds since the script started (`t_s`). Run it from the
checkout's root; it exits non-zero when any check fails.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

KERNELS = ("gemm", "conv_direct", "conv_dw")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cnn_mesh_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": smi, "torch": torch.__version__})
    for name in KERNELS:
        _kernels.lib(name)
    cs.emit({"phase": "build", "kernels": list(KERNELS),
             "seconds": time.perf_counter() - t0})
    gen = torch.Generator().manual_seed(0)
    t_cases = time.perf_counter()
    n = sum(1 for _ in cs.mesh_kernel_cases(torch, torch.device("cuda"), gen))
    cs.emit({"phase": "mesh_kernel_cases", "cases": n,
             "seconds": time.perf_counter() - t_cases})
    mesh = cs.phase_cnn_mesh(torch)
    cs.emit({"phase": "cnn_mesh_summary", "nvidia_smi": smi,
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

#!/usr/bin/env python3
"""The tools_search phase of `chip_smoke.py` alone, on one card:

    python3 tools/tools_search_phases.py

Builds every kernel, then runs `chip_smoke.py`'s `tools_search` phase
(runtime_abi's CNN and LM trainers on the card, `autosize` and its
frontier through an autoscaled engine fleet, `chaos`, `lint`), printing
its lines. Each line carries the seconds since the script started
(`t_s`). Run it from the checkout's root; it exits non-zero when any
check fails.
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
        print("tools_search_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": smi, "torch": torch.__version__})
    built = _kernels.build_all()
    cs.emit({"phase": "build", "seconds": built["seconds"]})
    tools = cs.phase_tools_search(torch)
    cs.emit({"phase": "tools_search", "nvidia_smi": smi, **tools["record"]})
    cs.emit({"phase": "launches", **tools["launches"]})
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

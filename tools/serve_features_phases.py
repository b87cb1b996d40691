#!/usr/bin/env python3
"""The serving phases of `chip_smoke.py` alone, on one card:

    python3 tools/serve_features_phases.py [--no-serve]

Builds K1 and K2 at first use, runs the kernel cases of the
serve_features phase's shapes (K1 at the verify block, over aliased
tables and the draft's pools; K2 at the verify block's N and the draft's
products), then `chip_smoke.py`'s `serve` phase (the flagship's 32
requests; `--no-serve` skips it) and its `serve_features` phase,
printing their lines. Each chip_smoke line carries the seconds since the
script started (`t_s`). Run it from the checkout's root; it exits
non-zero when any check fails.
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
        print("serve_features_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.serve import bench as serve_bench

    disable_tf32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": smi, "torch": torch.__version__})
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    args = serve_bench._parser().parse_args(cs.SERVE_ARGS)
    cs.features_kernel_cases(torch, dev, gen, args)
    if "--no-serve" not in sys.argv[1:]:
        cs.phase_serve(torch, cs.SERVE_ARGS)
    features = cs.phase_serve_features(torch)
    cs.emit({"phase": "serve_features", "nvidia_smi": smi,
             **features["record"]})
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

#!/usr/bin/env python3
"""chip_smoke.py's `dp` phase alone, after building the kernels: world 1
on a one-rank NCCL group, world 2 as two gloo ranks on cuda:0, and, on a
machine with two cards or more, world min(4, cards) over NCCL with one
rank a card. Prints the card line (`nvidia-smi` name and power limit)
and one JSON line per world, as chip_smoke.py does.

    python3 tools/dp_worlds.py

Exits non-zero without a card or when a world fails its checks.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dp_worlds: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()
    print(chip_smoke.nvidia_smi(), flush=True)
    chip_smoke.emit({"phase": "build",
                     "seconds": round(_kernels.build_all()["seconds"], 3)})
    chip_smoke.phase_dp(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

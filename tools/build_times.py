#!/usr/bin/env python3
"""Wall seconds of building every CUDA kernel of the checkout it is run
from (`ops._kernels.build_all`: one `nvcc` per source, all started
together, as `chip_smoke.py`'s build phase does), from an empty build
directory, and of building the three flash sources alone (together), with
the ptxas spill bytes of every flash kernel instance that spills
(`chip_smoke.spill_stores` of that checkout). One
JSON line: {"tag", "all_s", "flash_s", "flash_spills"}. Needs `nvcc`;
run it from the root of a checkout.

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change; do
      (cd build/$t && python3 ../../tools/build_times.py $t)
    done
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    shutil.rmtree(_kernels.BUILD_DIR, ignore_errors=True)
    built = _kernels.build_all()
    all_s = built["seconds"]
    spills = {fn: n for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
              for fn, n in chip_smoke.spill_stores(built["logs"][name]).items()
              if n}
    shutil.rmtree(_kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    jobs = [(name, _kernels._start_build(name))
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    for name, job in jobs:
        _kernels._finish_build(name, *job)
    flash_s = time.perf_counter() - t0
    shutil.rmtree(_kernels.BUILD_DIR, ignore_errors=True)
    print(json.dumps({"tag": tag, "all_s": all_s, "flash_s": flash_s,
                      "flash_spills": spills}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

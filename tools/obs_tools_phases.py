#!/usr/bin/env python3
"""The obs_tools phase of `chip_smoke.py` alone, on one card:

    python3 tools/obs_tools_phases.py

Builds every kernel, writes the run files the phase reads from the
earlier phases with one run each of theirs (serve_features' slo run and
the fleet phase's crash run at the serve flagship, train_flags (g)'s
sink run on FLAGS_TIME_STEPS x 4 stripes), then runs `chip_smoke.py`'s
`obs_tools` phase, printing its lines. Each line carries the seconds
since the script started (`t_s`). Run it from the checkout's root; it
exits non-zero when any check fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import json

    import torch

    if not torch.cuda.is_available():
        print("obs_tools_phases: no CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import fleet_bench, serve_bench

    disable_tf32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    cs.emit({"phase": "device", "name": torch.cuda.get_device_name(0),
             "nvidia_smi": smi, "torch": torch.__version__})
    built = _kernels.build_all()
    cs.emit({"phase": "build", "seconds": built["seconds"]})
    with tempfile.TemporaryDirectory(prefix="runs-") as tmp:
        cs.KEEP = keep = Path(tmp)
        keep.joinpath("slo.json").write_text(json.dumps(cs.FEATURES_SLO))
        (_, flags), = [r for r in cs.FEATURES_RUNS if r[0] == "slo"]
        serve_bench(cs.FEATURES_ARGS + [a.replace("{tmp}", tmp)
                                        for a in flags])
        keep.joinpath("features.jsonl").rename(keep / "serve_slo.jsonl")
        keep.joinpath("slo.json").rename(keep / "serve_slo.json")
        (_, flags), = [r for r in cs.FLEET_RUNS if r[0] == "crash"]
        fleet_bench(cs.FLEET_ARGS + flags + [
            "--log", "full", "--metrics-jsonl", str(keep / "fleet.jsonl")])
        dev = torch.device("cuda", 0)
        ds = synthetic_stripes(num_train=4 * cs.FLAGS_TIME_STEPS
                               * cs.CNN_BATCH, num_test=cs.RECOVER_TEST)
        cs.emit({"phase": "inputs", **cs.flags_sink(torch, dev, ds, keep)})
        cs.emit({"phase": "obs_tools", **cs.phase_obs_tools(torch)})
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

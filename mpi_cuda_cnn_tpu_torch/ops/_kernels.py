"""Build, load and count the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exports a plain C launch function and is compiled
on first use by `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` into `build/torch_kernels/lib<name>-<hash>.so` at the
repository root (the hash is of the source and of the shared
`csrc/*.cuh` headers, so an edited kernel rebuilds), then loaded with
`ctypes`. Nothing here runs at import time: the CPU tests import every
module on a machine with no `nvcc`.

`launches` counts, per kernel, the launches its wrapper made (one per
successful launch, nowhere else); `reset_launches()` zeroes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# kernel name -> (C launch function, its ctypes argument types)
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "paged_attention": ("paged_attention_launch",
                        [_P] * 10 + [_I] * 16 + [_P]),
    "int8_gemm": ("int8_gemm_launch", [_P] * 4 + [_I] * 3 + [_P]),
    "gemm": ("gemm_launch", [_P] * 6 + [_I] * 11 + [_P]),
    "conv_direct": ("conv_direct_launch", [_P] * 3 + [_I] * 19 + [_P]),
    "conv_dw": ("conv_dw_launch", [_P] * 5 + [_I] * 22 + [_P]),
    "conv_gemm": ("conv_gemm_launch", [_P] * 3 + [_I] * 19 + [_P]),
    "flash_fwd": ("flash_fwd_launch", [_P] * 5 + [_I] * 11 + [_P]),
    "flash_bwd_dq": ("flash_bwd_dq_launch", [_P] * 7 + [_I] * 11 + [_P]),
    "flash_bwd_dkv": ("flash_bwd_dkv_launch", [_P] * 9 + [_I] * 12 + [_P]),
}

# The element types the float kernels take, and their dtype code in the C
# launch functions (`csrc/elem.cuh`).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches: dict[str, int] = {name: 0 for name in KERNELS}
_fns: dict[str, object] = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path,
                  out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)
    return log


def _kept_log(name: str) -> str:
    path = _lib_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build_all() -> dict:
    """Build every kernel that is not built yet, one `nvcc` per source,
    all started together. Returns {"seconds": wall time, "logs": {name:
    nvcc output (register/shared-memory report), kept beside each library
    so that one built earlier has it too}}."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in KERNELS}
    logs = {name: (_finish_build(name, *job) if job is not None
                   else _kept_log(name))
            for name, job in started.items()}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def lib(name: str):
    """The loaded C launch function of kernel `name` (built on first
    use)."""
    fn = _fns.get(name)
    if fn is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, *job)
        fn_name, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")

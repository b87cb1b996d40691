"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never run on the CPU unless the CPU was asked for."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch._device import resolve_device
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.serve.bench import serve_bench, serve_bench_main
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

REPO = Path(__file__).resolve().parents[1]

# Runs in a fresh interpreter: this test process has imported jax and
# the JAX package already (tests/conftest.py).
_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import mpi_cuda_cnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "mpi_cuda_cnn_tpu" or m.startswith("mpi_cuda_cnn_tpu."))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout


# The three tools that need no card, run as a port user runs them, with
# neither jax nor the JAX package importable.
_TOOLS_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["mpi_cuda_cnn_tpu"] = None
from mpi_cuda_cnn_tpu_torch.cli import main
codes = [main(["autosize", "--budget", "2", "--requests", "8"]),
         main(["chaos", "--episodes", "1", "--seed", "3"]),
         main(["lint"])]
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "mpi_cuda_cnn_tpu" or m.startswith("mpi_cuda_cnn_tpu.")))
print(codes, leaked)
assert codes == [0, 0, 0] and not leaked, (codes, leaked)
"""


def test_autosize_chaos_lint_run_without_jax():
    out = subprocess.run([sys.executable, "-c", _TOOLS_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "auto", "cuda", "cuda:0"])
def test_cuda_requested_without_a_gpu_raises(no_gpu, device):
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device(device)


def test_engine_and_bench_refuse_to_fall_back_to_cpu(no_gpu, capsys):
    model = TransformerLM(vocab=16, dim=16, heads=2, depth=1, max_seq=32)
    params = model.init(prng.key(0))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        PagedEngine(model, params, num_pages=8, page_size=4)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve_bench(["--requests", "1"])
    assert serve_bench_main(["--requests", "1"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""            # no result line
    assert "CUDA device requested" in captured.err


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    params = params_from_jax({"w": np.ones((2, 2), np.float32)})
    assert params["w"].device == torch.device("cpu")

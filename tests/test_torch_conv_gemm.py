"""The port's implicit-GEMM conv (`kernel_ops.conv2d_gemm_kernel`, K6)
and its bench (`conv-bench`) against the JAX package on the CPU, with
inputs made by numpy from a seed and handed to both.

The JAX side is `conv2d_pallas_gemm` in Pallas interpret mode, as the
JAX package's own tests run it here. float32 results are held to
`max|got - want| <= 1e-5 * max|want|`: both sides sum up to 1,152
float32 products in other orders. bf16 results (dtype asserted) to a
relative L2 error of 1e-2: both sides sum in float32 and round once to
bf16 (2^-9 relative), so a sum that lands on the other side of a
rounding boundary moves one value by one bf16 ulp. The CUDA kernel runs
only on the card; here the wrappers take the plain versions (the launch
counts stay 0), and `chip_smoke.py` holds the kernel to its plain
version on an H100.
"""

import math
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.ops.pallas_conv_gemm import conv2d_pallas_gemm
from mpi_cuda_cnn_tpu_torch.bench import conv_shapes
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.ops import _kernels, conv, kernel_ops
from mpi_cuda_cnn_tpu_torch.utils.sync import two_point_ms
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

TOL = 1e-5
BF16_REL_L2 = 1e-2
# tests/test_pallas.py's GEMM_CASES, then the four stride-1 conv-bench
# shapes narrowed to batch 2 and a quarter of the channels (C = 3 kept:
# K = 27, the ragged K slices).
CASES = [
    (2, 8, 8, 16, 3, 8, 1, 1),
    (2, 6, 6, 2, 3, 3, 1, 0),
    (2, 8, 8, 3, 5, 4, 1, 2),
] + [(2, h, w, ci if ci < 4 else ci // 4, k, co // 4, s, p)
     for (_, h, w, ci, k, co, s, p) in conv_shapes.SHAPES if s == 1]
IDS = ["x".join(map(str, c[:6])) for c in CASES]


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"max abs err {err}"


def _assert_rel_l2(got, want, tol=BF16_REL_L2):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= tol, f"relative L2 error {rel}"


@pytest.fixture
def no_launch():
    """Asserts that the test launched no CUDA kernel (CPU tensors take
    the plain versions)."""
    before = dict(_kernels.launches)
    yield
    assert _kernels.launches == before


def _inputs(n, h, w, ci, k, co, scale=1.0):
    return _rand(n, h, w, ci), _rand(k, k, ci, co, seed=1) * np.float32(scale)


def _port(x, wk, pad, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(wk).to(dtype).requires_grad_(True)
    y = kernel_ops.conv2d_gemm_kernel(tx, tw, 1, pad)
    gx, gw = torch.autograd.grad((y.float() ** 2).sum(), (tx, tw))
    return y, gx, gw


def _jax(x, wk, pad, dtype):
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(wk, dtype)

    def f(a, b):
        return conv2d_pallas_gemm(a, b, 1, pad)

    y = f(jx, jw)
    gx, gw = jax.grad(lambda a, b: jnp.sum(f(a, b).astype(jnp.float32) ** 2),
                      argnums=(0, 1))(jx, jw)
    return y, gx, gw


@pytest.mark.parametrize("n,h,w,ci,k,co,stride,pad", CASES, ids=IDS)
def test_forward_and_gradients_match_pallas_gemm_f32(n, h, w, ci, k, co,
                                                     stride, pad, no_launch):
    x, wk = _inputs(n, h, w, ci, k, co)
    y, gx, gw = _port(x, wk, pad, torch.float32)
    want_y, want_gx, want_gw = _jax(x, wk, pad, jnp.float32)
    assert y.dtype == gx.dtype == gw.dtype == torch.float32
    _assert_close(y, want_y)
    _assert_close(gx, want_gx)
    _assert_close(gw, want_gw)


@pytest.mark.parametrize("n,h,w,ci,k,co,stride,pad", CASES, ids=IDS)
def test_forward_and_gradients_match_pallas_gemm_bf16(n, h, w, ci, k, co,
                                                      stride, pad, no_launch):
    x, wk = _inputs(n, h, w, ci, k, co, scale=0.1)
    y, gx, gw = _port(x, wk, pad, torch.bfloat16)
    want_y, want_gx, want_gw = _jax(x, wk, pad, jnp.bfloat16)
    assert y.dtype == gx.dtype == gw.dtype == torch.bfloat16
    assert want_y.dtype == jnp.bfloat16
    _assert_rel_l2(y, want_y)
    _assert_rel_l2(gx, want_gx)
    _assert_rel_l2(gw, want_gw)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_stride_other_than_one_raises(device):
    """Before any device decision: on the CPU, and on a tensor that never
    reaches a plain version."""
    x = torch.zeros((2, 8, 8, 4), device=device)
    w = torch.zeros((3, 3, 4, 4), device=device)
    with pytest.raises(ValueError, match="stride-1"):
        kernel_ops.conv2d_gemm_kernel(x, w, 2, 1)


@pytest.mark.parametrize("n,h,w,ci,k,co,stride,pad", CASES, ids=IDS)
def test_conv_gemm_plain_matches_the_torch_conv(n, h, w, ci, k, co, stride,
                                                pad, no_launch):
    x, wk = map(torch.from_numpy, _inputs(n, h, w, ci, k, co))
    want = conv.conv2d(x, wk, stride=1, padding=pad)
    _assert_close(kernel_ops.conv_gemm_plain(x, wk, padding=pad), want)
    _assert_close(kernel_ops.conv_gemm(x, wk, padding=pad), want)


def test_conv_gemm_plain_rounds_once_in_bf16(no_launch):
    """The bf16 plain version is the float32 product of the bf16 inputs,
    rounded to bf16 once."""
    x, wk = _inputs(2, 6, 6, 8, 3, 8)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, wk))
    got = kernel_ops.conv_gemm_plain(tx, tw, padding=1)
    want = conv.conv2d(tx.float(), tw.float(), padding=1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want.float(), 0)


def _stub(dtype, device="cuda:0"):
    """What `_check` reads of a tensor, as a CUDA tensor would show it."""
    return SimpleNamespace(is_cuda=True, device=torch.device(device),
                           dtype=dtype, is_contiguous=lambda: True)


def test_check_takes_float32_or_bf16_of_one_type():
    assert kernel_ops._check("k", _stub(torch.float32), _stub(torch.float32)) == 0
    assert kernel_ops._check("k", _stub(torch.bfloat16),
                             _stub(torch.bfloat16)) == 1
    for dtypes in ((torch.float16,), (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32), (torch.float64,)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernel_ops._check("k", *map(_stub, dtypes))
    with pytest.raises(ValueError, match="one CUDA device"):
        kernel_ops._check("k", _stub(torch.float32), _stub(torch.float32, "cuda:1"))


def test_two_point_ms_times_windows_on_the_cpu():
    calls = []

    def fn(a):
        calls.append(a)

    ms = two_point_ms(fn, 3, torch.zeros(1), reps=2)
    assert len(calls) == 3 + 2 * (3 + 6)   # warm-up window, then n and 2n
    assert math.isfinite(ms)
    with pytest.raises(ValueError):
        two_point_ms(fn, 0, torch.zeros(1))


# The reference's line, with the port's backend names (a two-point time
# of a CPU call this small can come out below 0: T(2n) and T(n) are noise).
_T = r"(-?[\d.]+|nan)"
LINE = re.compile(
    r"(f32|bf16) (\d+)x(\d+)x(\d+)x(\d+) k(\d+) -> (\d+) s(\d+): "
    rf"torch +{_T} ms  cuda +{_T} ms  gemm +{_T} ms  ratio +{_T}/ *{_T}")


def test_conv_bench_on_the_cpu(monkeypatch, capsys, no_launch):
    small = [(2, 8, 8, 3, 3, 8, 1, 1), (2, 8, 8, 16, 3, 16, 1, 1),
             (2, 6, 6, 16, 3, 32, 1, 1), (2, 4, 4, 32, 3, 64, 1, 1),
             (2, 7, 7, 1, 3, 4, 2, 1)]
    monkeypatch.setattr(conv_shapes, "SHAPES", small)
    assert main(["conv-bench", "--device", "cpu", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * len(small)
    for i, line in enumerate(lines):
        m = LINE.fullmatch(line)
        assert m, line
        dt, shape = m.group(1), small[i % len(small)]
        assert dt == ("f32" if i < len(small) else "bf16")
        assert tuple(int(m.group(j)) for j in range(2, 9)) == (
            *shape[:4], shape[4], shape[5], shape[6])
        assert m.group(9) != "nan" and m.group(10) != "nan"
        assert (m.group(11) == "nan") == (shape[6] != 1)
        assert (m.group(13) == "nan") == (shape[6] != 1)
    assert conv_shapes.conv_bench(["--device", "cpu", "--iters", "1"])[
        "device"] == "cpu"


def test_conv_bench_keeps_the_reference_shapes_and_refuses_a_missing_card(
        monkeypatch, capsys):
    assert conv_shapes.SHAPES == [
        (128, 32, 32, 3, 3, 64, 1, 1), (128, 32, 32, 64, 3, 64, 1, 1),
        (128, 16, 16, 64, 3, 128, 1, 1), (128, 8, 8, 128, 3, 256, 1, 1),
        (32, 28, 28, 1, 3, 16, 2, 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["conv-bench", "--iters", "1"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA device requested" in captured.err

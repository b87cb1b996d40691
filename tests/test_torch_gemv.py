"""The port's int8 weights (mpi_cuda_cnn_tpu_torch/ops/gemv.py) against
the JAX package's `ops/pallas_gemv.py`.

Quantization is bitwise: the same float32 absmax, division and round
half to even on both sides. The product is held to rtol 1e-5 of max|y|:
the JAX kernel (interpret mode on the CPU) computes (x @ q) * s while
the port's plain version computes x @ (q * s), and the JAX package
itself already drifts 1.1e-5 at |y| ~ 25 between those two forms. The
CUDA kernel runs only on the card, where chip_smoke.py holds it against
the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.ops.pallas_gemv import (
    QuantW as JaxQuantW,
    int8_gemv as jax_int8_gemv,
    quantize_decode_params as jax_quantize_decode_params,
    quantize_weight as jax_quantize_weight,
)
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.ops.gemv import (
    QuantW,
    dequantize_decode_params,
    dequantize_weight,
    int8_gemv,
    qmatmul,
    quantize_decode_params,
    quantize_weight,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

RTOL_OF_MAX = 1e-5
SHAPES = [(32, 32), (32, 16), (32, 128), (128, 32), (32, 64), (24, 40)]


def _weight(seed, din, dout):
    w = np.random.default_rng(seed).normal(size=(din, dout)).astype(np.float32)
    w /= np.sqrt(din)
    w[:, 1] = 0.0                      # an all-zero column hits the scale floor
    return w


@pytest.mark.parametrize("din,dout", SHAPES)
def test_quantize_weight_bitwise(din, dout):
    w = _weight(0, din, dout)
    want = jax_quantize_weight(jnp.asarray(w))
    got = quantize_weight(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_array_equal(dequantize_weight(got).numpy(),
                                  np.asarray(want.q.astype(jnp.float32) * want.s))


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("din,dout", SHAPES)
def test_int8_gemv_plain_matches_jax(din, dout, n):
    w = _weight(1, din, dout)
    x = np.random.default_rng(2).normal(size=(n, din)).astype(np.float32) * 5
    want = np.asarray(jax_int8_gemv(jnp.asarray(x),
                                    jax_quantize_weight(jnp.asarray(w))))
    before = dict(_kernels.launches)
    got = int8_gemv(torch.from_numpy(x), quantize_weight(torch.from_numpy(w)))
    assert _kernels.launches == before  # CPU tensors: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, dout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(want).max())


def test_qmatmul_dispatch_and_leading_shape():
    """A plain tensor takes `@`; a QuantW takes int8_gemv over the
    flattened leading shape."""
    w = torch.from_numpy(_weight(3, 32, 48))
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 5, 32)).astype(np.float32))
    torch.testing.assert_close(qmatmul(x, w), x @ w, rtol=0, atol=0)
    qw = quantize_weight(w)
    got = qmatmul(x, qw)
    assert tuple(got.shape) == (2, 5, 48)
    torch.testing.assert_close(
        got, int8_gemv(x.reshape(10, 32), qw).reshape(2, 5, 48),
        rtol=0, atol=0)


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_quantize_decode_params_converts_the_same_leaves(kv_heads):
    """int8 turns the same leaves into QuantW as the JAX package does
    (every block matmul and the head; embeddings and layernorms stay
    float32) with bitwise equal values; float32 passes through; the
    dequantized view gives back float32 matrices of the same shapes."""
    model = JaxLM(vocab=64, dim=32, heads=4, depth=2, max_seq=64,
                  kv_heads=kv_heads)
    jp = model.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    want = jax_quantize_decode_params(jp, "int8")
    got = quantize_decode_params(tp, "int8")
    assert quantize_decode_params(tp, "float32") is tp

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif isinstance(a, JaxQuantW):
            assert isinstance(b, QuantW), path
            np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q), path)
            np.testing.assert_array_equal(b.s.numpy(), np.asarray(a.s), path)
        else:
            assert isinstance(b, torch.Tensor), path
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), path)

    walk(want, got, "")
    deq = dequantize_decode_params(got)
    assert deq["head"].dtype == torch.float32
    assert deq["head"].shape == tp["head"].shape
    for blk in deq["blocks"]:
        assert not any(isinstance(v, QuantW) for v in blk.values())

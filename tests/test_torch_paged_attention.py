"""The port's paged-attention read (mpi_cuda_cnn_tpu_torch/ops/
paged_attention.py) and paged cache write (serve/paged_cache.py)
against the JAX package's.

The same numpy inputs go through the JAX `paged_attend` (its Pallas
kernel, in interpret mode on the CPU) and the port's `paged_attend`,
which on CPU tensors takes its plain version (gather + attend_kv). The
CUDA kernel itself runs only on the card, where chip_smoke.py holds it
against the plain version.

Tolerances: f32 and int8 pages atol 1e-5 (same elementwise math, the
sums run in another order); bf16 pages atol 1e-2 (bf16 probabilities
are rounded at different places by the two frameworks' contractions).
The cache write is bitwise: it is a scatter plus the int8 quantizer,
whose division and round-half-to-even are the same in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.ops.pallas_paged_attention import (
    paged_attend as jax_paged_attend,
)
from mpi_cuda_cnn_tpu.serve.paged_cache import (
    paged_update_attend as jax_paged_update_attend,
)
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.ops.paged_attention import paged_attend
from mpi_cuda_cnn_tpu_torch.serve.paged_cache import paged_update_attend
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

ATOL = {"float32": 1e-5, "int8": 1e-5, "bfloat16": 1e-2}
HEADS = 4
HKV = {"mha": 4, "gqa": 2, "mqa": 1}
HD, PS, CHUNK = 8, 8, 4


def _pages(rng, dtype, pool, hkv):
    """One layer's page dict as (numpy for jax, torch) pairs: f32 values
    cast to the storage dtype on both sides (the same round to nearest
    even for bf16), int8 values with positive f32 scales."""
    shape = (pool, PS, hkv, HD)
    if dtype == "int8":
        arrs = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32),
                "vs": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)}
        return ({n: jnp.asarray(a) for n, a in arrs.items()},
                {n: torch.from_numpy(a.copy()) for n, a in arrs.items()})
    arrs = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    return ({n: jnp.asarray(a, jdt) for n, a in arrs.items()},
            {n: torch.from_numpy(a.copy()).to(tdt) for n, a in arrs.items()})


def _case(seed, dtype, hkv, kk, *, b=3, npages=5, pool=20):
    """Random distinct block tables (the last column of slot 0 is the
    scratch page 0, as an unused column is in the engine), positions
    that end mid-page, and q."""
    rng = np.random.default_rng(seed)
    jc, tc = _pages(rng, dtype, pool, hkv)
    table = np.stack([rng.choice(np.arange(1, pool), npages, replace=False)
                      for _ in range(b)]).astype(np.int32)
    table[0, -1] = 0
    hi = (npages - 1) * PS - kk        # slot 0 never reaches its scratch column
    pos0 = rng.integers(0, hi, (b, 1))
    pos0[pos0 % PS == PS - 1] -= 1     # every extent ends mid-page
    positions = (pos0 + np.arange(kk)[None, :]).astype(np.int32)
    q = rng.normal(size=(b, kk, HEADS, HD)).astype(np.float32)
    return q, jc, tc, table, positions


@pytest.mark.parametrize("kk", [1, CHUNK], ids=["decode", "chunk"])
@pytest.mark.parametrize("head", list(HKV))
@pytest.mark.parametrize("dtype", list(ATOL))
def test_paged_attend_matches_jax(dtype, head, kk):
    for seed in range(2):
        q, jc, tc, table, positions = _case(seed, dtype, HKV[head], kk)
        want = np.asarray(jax_paged_attend(
            jnp.asarray(q), jc, jnp.asarray(positions), jnp.asarray(table),
            PS))
        before = dict(_kernels.launches)
        got = paged_attend(torch.from_numpy(q), tc,
                           torch.from_numpy(positions),
                           torch.from_numpy(table), PS)
        assert _kernels.launches == before  # CPU tensors: plain version
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ATOL[dtype],
                                   err_msg=f"{dtype} {head} kk={kk} seed={seed}")


@pytest.mark.parametrize("dtype", list(ATOL))
def test_paged_update_attend_write_matches_jax(dtype):
    """The scatter write: live rows land at block_table[p // ps] offset
    p % ps, invalid rows (a dead slot, a padding token) at scratch page
    0 offset 0; the resulting pools equal JAX's bit for bit, and the
    read after the write agrees within the file's tolerance. Several
    invalid rows land on the same scratch row, where the last writer is
    not part of either contract, so the scratch page is left out of the
    bitwise check."""
    rng = np.random.default_rng(7)
    hkv, kk = 2, CHUNK
    q, jc, tc, table, positions = _case(3, dtype, hkv, kk)
    k = rng.normal(size=(3, kk, hkv, HD)).astype(np.float32)
    v = rng.normal(size=(3, kk, hkv, HD)).astype(np.float32)
    valid = np.ones((3, kk), bool)
    valid[1] = False                 # a dead slot
    valid[2, -1] = False             # a padding token
    jo, jnew = jax_paged_update_attend(
        jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), jnp.asarray(valid), jnp.asarray(table), PS,
        kernel="pallas")
    to, tnew = paged_update_attend(
        tc, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions), torch.from_numpy(valid),
        torch.from_numpy(table), PS, kernel="cuda")
    assert set(tnew) == set(jnew)
    for name in jnew:
        want = np.asarray(jnew[name].astype(jnp.float32))[1:]
        got = tnew[name].to(torch.float32).numpy()[1:]
        np.testing.assert_array_equal(got, want, err_msg=f"{dtype} {name}")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=ATOL[dtype], err_msg=dtype)


def test_kernel_and_gather_reads_agree_on_cpu():
    """`kernel="cuda"` and `kernel="gather"` give the same read on CPU
    tensors: both take the plain version there, and neither launches a
    kernel."""
    q, _, tc, table, positions = _case(5, "int8", 2, CHUNK)
    outs = []
    before = dict(_kernels.launches)
    for kernel in ("gather", "cuda"):
        c = {n: t.clone() for n, t in tc.items()}
        o, _ = paged_update_attend(
            c, torch.from_numpy(q), torch.zeros(3, CHUNK, 2, HD),
            torch.zeros(3, CHUNK, 2, HD), torch.from_numpy(positions),
            torch.zeros(3, CHUNK, dtype=torch.bool),
            torch.from_numpy(table), PS, kernel=kernel)
        outs.append(o)
    assert _kernels.launches == before
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)

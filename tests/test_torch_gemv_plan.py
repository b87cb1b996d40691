"""The launch plan of the int8 weight matmul K2 (`gemv.int8_gemm_plan`,
which `gemv.int8_gemv` hands to `csrc/int8_gemm.cu`), at the serving
engine's ten products (d 512, 8 query / 2 KV heads, vocab 8192: wq / wo
512 -> 512, wkv 512 -> 256, w1 512 -> 2048, w2 2048 -> 512 and the head
512 -> 8192, at N 8 for a decode tick and N 32 for a prefill chunk), at
an MHA model's fused wqkv (512 -> 1536), at chip_smoke.py's ragged
cases, at 24 rows a block (N 20) and at more than 32 rows (N 100), and
at tests/test_torch_gemv.py's small shapes at N 1, 4 and 8.

At each, the plan must:
- cover every output once with its (row block, column tile) blocks, and
  din once with its splits, as increasing runs of whole 32-row slices
  (the fixed order of the split sum);
- put at least 100 blocks on the card wherever the product has that many
  (row block, tile, slice) triples, and otherwise as many as it has;
- size the splits' scratch and counters to the grid, give every output
  quad a summing thread, and fit its shared memory;
- copy q as wide as dout allows and refuse a misaligned q there; copy x
  16 bytes at a time exactly where din % 4 == 0 and x is aligned.

Then a numpy emulation of the kernel at every one of those shapes: the
zero-filled slabs of each block, each thread's k-lane walk over groups
of 4 rows, the k-lanes summed in order, the split partials summed in
split order and then scaled, held to `int8_gemv_plain` and to the JAX
package's `int8_gemv` (interpret mode on the CPU) within
tests/test_torch_gemv.py's tolerance (1e-5 of max|y|). CPU only: the
kernel itself is held to its plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.ops.pallas_gemv import (
    int8_gemv as jax_int8_gemv,
    quantize_weight as jax_quantize_weight,
)
from mpi_cuda_cnn_tpu_torch.ops import gemv
from mpi_cuda_cnn_tpu_torch.ops.gemv import int8_gemv_plain, quantize_weight
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

RTOL_OF_MAX = 1e-5
ALIGNED = 0x7F0000000100
SMEM_LIMIT = 227 * 1024
MIN_BLOCKS = 100
TN = gemv.TILE_N

SERVING = {f"N{n} {din}->{dout}": (n, din, dout)
           for n in (8, 32)
           for din, dout in ((512, 512), (512, 256), (512, 2048),
                             (2048, 512), (512, 8192), (512, 1536))}
RAGGED = {"N1 512->512": (1, 512, 512), "N5 200->40": (5, 200, 40),
          "N3 203->37": (3, 203, 37), "N20 512->512": (20, 512, 512),
          "N100 300->96": (100, 300, 96)}
SMALL = {f"N{n} {din}->{dout}": (n, din, dout)
         for n in (1, 4, 8)
         for din, dout in ((32, 32), (32, 16), (32, 128), (128, 32),
                           (32, 64), (24, 40))}
SHAPES = {**SERVING, **RAGGED, **SMALL}


def _plan(n, din, dout, q_ptr=ALIGNED, x_ptr=ALIGNED):
    return gemv.int8_gemm_plan(n, din, dout, q_ptr=q_ptr, x_ptr=x_ptr)


def _runs(plan, din):
    """The din run [k0, k1) of each split, in split order."""
    return [(z * plan.kslice, min(din, (z + 1) * plan.kslice))
            for z in range(plan.splits)]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_fills_and_fits(name):
    n, din, dout = SHAPES[name]
    plan = _plan(n, din, dout)
    # blocks cover every output once
    assert plan.rows == min(32, -(-n // 8) * 8)
    assert plan.row_blocks == -(-n // plan.rows)
    assert plan.tiles == -(-dout // TN)
    assert plan.grid == plan.row_blocks * plan.tiles * plan.splits
    cover = np.zeros((plan.row_blocks * plan.rows, plan.tiles * TN), np.int64)
    for b in range(plan.grid // plan.splits):   # split fastest in the grid
        rb, tile = divmod(b, plan.tiles)
        cover[rb * plan.rows:(rb + 1) * plan.rows,
              tile * TN:(tile + 1) * TN] += 1
    assert (cover == 1).all()
    # splits cover din once, as increasing runs of whole 32-row slices
    assert plan.kslice % 32 == 0 and 32 <= plan.kslice <= 512
    runs = _runs(plan, din)
    assert all(k0 < k1 for k0, k1 in runs)
    assert [k for k0, k1 in runs for k in range(k0, k1)] == list(range(din))
    # at least 100 blocks where the product has that many triples
    slices = -(-din // 32)
    triples = plan.row_blocks * plan.tiles * slices
    if triples >= MIN_BLOCKS:
        assert plan.grid >= MIN_BLOCKS
    else:
        assert plan.splits == slices and plan.grid == triples
    assert plan.grid <= 2 * 132 or plan.splits == -(-din // 512)
    # threads, scratch, counters, shared memory
    assert plan.threads == plan.rows * plan.k_lanes <= 256
    assert plan.k_lanes == min(256 // plan.rows // 8 * 8, plan.kslice // 4)
    assert plan.k_lanes % 8 == 0     # the k-lane sum takes 8 at a time
    assert plan.threads >= plan.rows * TN // 4   # a thread per output quad
    split = plan.splits > 1
    assert plan.scratch == (plan.grid * plan.rows * TN if split else 0)
    assert plan.counters == (plan.row_blocks * plan.tiles if split else 0)
    slabs = plan.kslice * (TN + 16) + plan.rows * plan.kslice * 4
    assert plan.smem_bytes == max(slabs, plan.threads * 8 * 4 * 4)
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # copy widths
    assert plan.q_vec == next(v for v in (16, 8, 4, 1) if dout % v == 0)
    assert plan.x_vec == (16 if din % 4 == 0 else 4)


def test_serving_products_fill_the_card():
    """Every serving product runs as one launch of 128 to 256 blocks, one
    to two per SM of the H100 (132)."""
    for name, shape in SERVING.items():
        plan = _plan(*shape)
        assert 128 <= plan.grid <= 2 * 132, (name, plan)


@pytest.mark.parametrize("name", ["N8 512->8192", "N32 2048->512",
                                  "N5 200->40", "N3 203->37",
                                  "N4 24->40"])
def test_plan_copy_widths_and_alignment(name):
    """q: refused where misaligned for the width dout allows; x: 4-byte
    copies where misaligned or din % 4 != 0, never a refusal."""
    n, din, dout = SHAPES[name]
    plan = _plan(n, din, dout)
    if plan.q_vec > 1:
        with pytest.raises(ValueError, match=f"{plan.q_vec}-byte aligned"):
            _plan(n, din, dout, q_ptr=ALIGNED + plan.q_vec // 2)
    else:
        assert _plan(n, din, dout, q_ptr=ALIGNED + 1) == plan
    shifted = _plan(n, din, dout, x_ptr=ALIGNED + 4)
    assert shifted.x_vec == 4
    assert shifted._replace(x_vec=plan.x_vec) == plan


def test_plan_refuses_an_empty_product():
    for shape in ((0, 512, 512), (8, 0, 512), (8, 512, 0)):
        with pytest.raises(ValueError, match="empty product"):
            _plan(*shape)


def emulate(x: np.ndarray, q: np.ndarray, s: np.ndarray,
            plan) -> np.ndarray:
    """csrc/int8_gemm.cu in numpy, float32 throughout: each block's
    zero-filled slabs (rows x kslice of x, kslice x 32 of q), each
    thread's k-lane walk (groups of 4 rows kl, kl + k_lanes, ... below
    ceil(kvalid / 4); within a group rows in order), the k-lanes' tiles
    summed in k-lane order, the splits summed in split order, then the
    scale. Vectorized over row blocks, splits, tiles, k-lanes, rows and
    columns."""
    n, din = x.shape
    dout = q.shape[1]
    rows, rbs, tiles = plan.rows, plan.row_blocks, plan.tiles
    ks, sp, kl = plan.kslice, plan.splits, plan.k_lanes
    xp = np.zeros((rbs * rows, sp * ks), np.float32)
    xp[:n, :din] = x
    qp = np.zeros((sp * ks, tiles * TN), np.float32)
    qp[:din, :dout] = q.astype(np.float32)
    xs = xp.reshape(rbs, rows, sp, ks).transpose(0, 2, 1, 3)  # (rb, z, r, k)
    qs = qp.reshape(sp, ks, tiles, TN).transpose(0, 2, 1, 3)  # (z, t, k, c)
    kvalid = np.minimum(ks, din - np.arange(sp) * ks)
    groups = -(-kvalid // 4)                                   # per split
    lanes = np.arange(kl)
    acc = np.zeros((rbs, sp, tiles, kl, rows, TN), np.float32)
    for j in range(-(-(ks // 4) // kl)):
        g = lanes + kl * j
        live = (g[None, :] < groups[:, None])[None, :, None, :, None, None]
        for i in range(4):
            k = np.minimum(4 * g + i, ks - 1)
            xk = xs[:, :, :, k].transpose(0, 1, 3, 2)[:, :, None, :, :, None]
            wk = qs[:, :, k, :][None, :, :, :, None, :]
            acc = np.where(live, acc + xk * wk, acc)
    part = acc[:, :, :, 0]
    for lane in range(1, kl):
        part = part + acc[:, :, :, lane]                      # (rb, z, t, r, c)
    tot = part[:, 0]
    for z in range(1, sp):
        tot = tot + part[:, z]                                # (rb, t, r, c)
    y = tot.transpose(0, 2, 1, 3).reshape(rbs * rows, tiles * TN)
    return y[:n, :dout] * s.astype(np.float32)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulated_kernel_matches_plain_and_jax(name):
    n, din, dout = SHAPES[name]
    rng = np.random.default_rng(din * 7 + dout + n)
    w = (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32)
    w[:, 1] = 0.0                      # an all-zero column hits the scale floor
    x = (rng.normal(size=(n, din)) * 5).astype(np.float32)
    qw = quantize_weight(torch.from_numpy(w))
    got = emulate(x, qw.q.numpy(), qw.s.numpy(), _plan(n, din, dout))
    plain = int8_gemv_plain(torch.from_numpy(x), qw).numpy()
    ref = np.asarray(jax_int8_gemv(jnp.asarray(x),
                                   jax_quantize_weight(jnp.asarray(w))))
    assert got.dtype == np.float32 and got.shape == (n, dout)
    for want in (plain, ref):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL_OF_MAX * np.abs(want).max())

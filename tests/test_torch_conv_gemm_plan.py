"""The tile plan of the implicit-GEMM conv kernel K6
(`kernel_ops.conv_gemm_plan`, which `kernel_ops.conv_gemm` hands to
`csrc/conv_gemm.cu`), at conv-bench's stride-1 rows, at every preset's
stride-1 conv forward (recorded from a CPU step through the kernel
backend) at batches 32, 128 and 2048, and at ragged shapes (C 3, O 40, odd
H and W, a 5 x 5 kernel, a C too deep for one halo slice).

At each, in float32 and bf16, the plan must:
- cover every output (pixel, channel) exactly once;
- stay within the grid limits and 227 KB of shared memory;
- copy x in 16-byte chunks exactly where C is a multiple of a 16-byte
  chunk, w exactly where O is, and refuse a misaligned operand there.

Then a numpy emulation of the kernel's addressing: for every block of a
small geometry it builds the halo from x as the kernel's halo load does
(slice by slice, zero-filled), reads every step's A rows at the addresses
the lanes hand to `ldmatrix` (halo pixel of the row plus the tap's shift)
and the step's weight rows as the ring load does. The A rows must equal
the rows of the patch matrix P that `conv_gemm_plain` builds (P comes out
of it exactly, with identity weights), and the sum of the steps' products
must equal `conv_gemm_plain`'s y. This catches index errors here, where
no GPU exists; the kernel itself is held to its plain version on the card
by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch.bench.conv_shapes import SHAPES
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import MODEL_PRESETS, get_model
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

SMEM_LIMIT = 227 * 1024            # a block's shared memory on the H100
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535
ALIGNED = 0x7F0000000100           # a 256-byte aligned device address
ITEMSIZES = {"float32": 4, "bfloat16": 2}
BATCHES = (32, 128, 2048)


def _geom(n, h, w, c, o, k, pad) -> dict:
    return dict(n=n, h=h, w=w, c=c, o=o, k=k, pad=pad)


FIXED = {
    **{f"conv-bench {n}x{h}x{w}x{c}->{o}": _geom(n, h, w, c, o, k, p)
       for (n, h, w, c, k, o, s, p) in SHAPES if s == 1},
    "ragged C 3, O 40, odd H and W": _geom(3, 9, 11, 3, 40, 3, 1),
    "ragged C 24, O 40, k5 p2": _geom(2, 7, 13, 24, 40, 5, 2),
    "O off the 16-byte grid": _geom(5, 10, 10, 16, 6, 3, 0),
    "deep C, sliced halo": _geom(4, 6, 6, 1024, 64, 3, 1),
    "wide rows": _geom(1, 3, 300, 8, 16, 3, 1),
}


def _plan(g: dict, itemsize: int, x_ptr: int = ALIGNED,
          w_ptr: int = ALIGNED) -> kernel_ops.ConvGemmPlan:
    return kernel_ops.conv_gemm_plan(g["n"], g["h"], g["w"], g["c"], g["o"],
                                     g["k"], g["k"], g["pad"],
                                     itemsize=itemsize, x_ptr=x_ptr,
                                     w_ptr=w_ptr)


def _out_hw(g: dict) -> tuple[int, int]:
    return (g["h"] + 2 * g["pad"] - g["k"] + 1,
            g["w"] + 2 * g["pad"] - g["k"] + 1)


def _block_pixels(plan, n, oh, ow):
    """(block, tile row) -> output pixel index or -1, as the kernel maps
    blockIdx.x and its 128 rows (numpy, all blocks at once)."""
    tiles_x, tiles_y = -(-ow // plan.tw), -(-oh // plan.th)
    b = np.arange(plan.grid_m)[:, None]
    r = np.arange(kernel_ops._TILE_PIXELS)[None, :]
    ox0 = (b % tiles_x) * plan.tw
    oy0 = (b // tiles_x % tiles_y) * plan.th
    n0 = b // tiles_x // tiles_y * plan.ni
    per = plan.th * plan.tw
    i, rem = r // per, r % per
    nn, oy, ox = n0 + i, oy0 + rem // plan.tw, ox0 + rem % plan.tw
    ok = (r < plan.ni * per) & (nn < n) & (oy < oh) & (ox < ow)
    return np.where(ok, (nn * oh + oy) * ow + ox, -1)


def _check_plan(g: dict, itemsize: int) -> kernel_ops.ConvGemmPlan:
    n, c, o, k = g["n"], g["c"], g["o"], g["k"]
    oh, ow = _out_hw(g)
    plan = _plan(g, itemsize)
    assert plan.ni * plan.th * plan.tw <= kernel_ops._TILE_PIXELS
    assert plan.ni <= n and plan.th <= oh and plan.tw <= ow
    assert plan.bn in kernel_ops._GEMM_BNS[itemsize]
    # every output pixel exactly once over the blocks' rows, every channel
    # exactly once over the channel tiles
    pix = _block_pixels(plan, n, oh, ow)
    cover = np.bincount(pix[pix >= 0], minlength=n * oh * ow)
    assert cover.shape == (n * oh * ow,) and (cover == 1).all()
    assert ((pix >= 0).any(axis=1)).all(), "a block wholly outside the output"
    cols = np.zeros(o, np.int64)
    for b in range(plan.grid_n):
        assert b * plan.bn < o
        cols[b * plan.bn:(b + 1) * plan.bn] += 1
    assert (cols == 1).all()
    assert 1 <= plan.grid_m <= GRID_X_MAX and 1 <= plan.grid_n <= GRID_Y_MAX
    assert n * oh * ow < 2 ** 31
    # C padded to the step unit, sliced evenly, stepped evenly
    unit = 16 if itemsize == 2 else 4
    assert plan.cp == -(-c // unit) * unit
    assert plan.cp % plan.cs == 0 and plan.cs % unit == 0
    assert plan.cs % plan.kc == 0 and plan.kc in ((16, 32) if itemsize == 2
                                                  else (4, 8, 16))
    # the deepest step the slice allows
    assert plan.kc == max(k for k in ((16, 32) if itemsize == 2
                                      else (4, 8, 16)) if plan.cs % k == 0)
    hh, hw = plan.th + k - 1, plan.tw + k - 1
    chunk = 16 // itemsize
    ring_rows = 32 if itemsize == 2 else 16
    assert plan.smem_bytes == itemsize * (
        4 * ring_rows * (plan.bn + chunk)
        + plan.ni * hh * hw * (plan.cs + chunk))
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # 16-byte copies of x where C is on the 16-byte grid, of w where O is;
    # a misaligned operand is refused where it would be copied so, and
    # taken element-wise where it would not
    assert plan.x_vec == (c % chunk == 0) and plan.w_vec == (o % chunk == 0)
    for x_ptr, w_ptr, copied in ((ALIGNED + itemsize, ALIGNED, plan.x_vec),
                                 (ALIGNED, ALIGNED + 8, plan.w_vec)):
        if copied:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _plan(g, itemsize, x_ptr, w_ptr)
        else:
            assert _plan(g, itemsize, x_ptr, w_ptr) == plan
    return plan


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("name", sorted(FIXED))
def test_plan_at_fixed_geometries(name, dtype):
    _check_plan(FIXED[name], ITEMSIZES[dtype])


def test_plan_at_the_bench_shapes_fills_the_card():
    """conv-bench's deep rows get at least one block per SM, and their
    halo holds all of C at once in bf16."""
    for (n, h, w, c, k, o, s, p) in SHAPES:
        if s != 1 or c < 64:
            continue
        plan = _plan(_geom(n, h, w, c, o, k, p), 2)
        assert plan.grid_m * plan.grid_n >= kernel_ops._SMS
        assert plan.cs == plan.cp == c and plan.x_vec and plan.w_vec


def _preset_forwards(preset: str) -> list[dict]:
    """The stride-1 conv forwards of one training step of `preset` on the
    kernel backend (batch 2), recorded from the plain version the CPU
    wrapper calls."""
    calls = []
    plain = kernel_ops.conv_direct_plain

    def record(x, w, *, stride, pads, dil, flip):
        if not flip and stride == 1 and dil == 1:
            assert len(set(pads)) == 1 and w.shape[0] == w.shape[1]
            n, h, wd, c = x.shape
            calls.append(_geom(n, h, wd, c, w.shape[3], w.shape[0], pads[0]))
        return plain(x, w, stride=stride, pads=pads, dil=dil, flip=flip)

    model = get_model(preset)
    params = model.init(prng.key(0),
                        get_initializer("normal"))
    x = torch.rand(2, *model.input_shape)
    kernel_ops.conv_direct_plain = record
    try:
        model.apply(params, x, backend="cuda")
    finally:
        kernel_ops.conv_direct_plain = plain
    assert tree_leaves(params)
    return calls


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_plan_at_every_preset_stride1_forward(preset):
    calls = _preset_forwards(preset)
    assert calls or preset == "reference_cnn"   # its convs are stride 2
    for g in calls:
        for batch in BATCHES:
            for itemsize in ITEMSIZES.values():
                _check_plan({**g, "n": batch}, itemsize)


def _emulate(x: np.ndarray, w: np.ndarray, pad: int, plan):
    """The kernel's arithmetic in numpy, block by block: its halo slices,
    its per-step A rows at the lanes' addresses and weight-ring rows, the
    sum of the steps' products. Returns (y as the kernel stores it, every
    (output pixel, K column) value an A row gave)."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    hh, hw = plan.th + kh - 1, plan.tw + kw - 1
    tiles_x, tiles_y = -(-ow // plan.tw), -(-oh // plan.th)
    w_flat = w.reshape(kh * kw * c, o)
    y = np.full((n * oh * ow, o), np.nan, np.float32)
    a_seen = np.full((n * oh * ow, kh * kw * c), np.nan, np.float32)
    pix = _block_pixels(plan, n, oh, ow)
    per = plan.th * plan.tw
    rows = np.arange(kernel_ops._TILE_PIXELS)
    i, rem = rows // per, rows % per
    # halo pixel of each tile row at tap (0, 0); 0 past the tile
    base = np.where(rows < plan.ni * per,
                    (i * hh + rem // plan.tw) * hw + rem % plan.tw, 0)
    hp = np.arange(plan.ni * hh * hw)
    hi, hy, hx = hp // (hh * hw), hp % (hh * hw) // hw, hp % hw
    for bx in range(plan.grid_m):
        ox0 = (bx % tiles_x) * plan.tw
        oy0 = (bx // tiles_x % tiles_y) * plan.th
        n0 = bx // tiles_x // tiles_y * plan.ni
        nn, iy, ix = n0 + hi, oy0 - pad + hy, ox0 - pad + hx
        inside = (nn < n) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
        live = pix[bx] >= 0
        for by in range(plan.grid_n):
            col0 = by * plan.bn
            acc = np.zeros((kernel_ops._TILE_PIXELS, plan.bn), np.float64)
            for cs0 in range(0, plan.cp, plan.cs):
                halo = np.zeros((len(hp), plan.cs), np.float32)
                for cc in range(plan.cs):
                    if cs0 + cc < c:
                        halo[inside, cc] = x[nn[inside], iy[inside],
                                             ix[inside], cs0 + cc]
                for tap in range(kh * kw):
                    ky, kx = divmod(tap, kw)
                    for c0 in range(0, plan.cs, plan.kc):
                        a = halo[base + ky * hw + kx, c0:c0 + plan.kc]
                        ring = np.zeros((plan.kc, plan.bn), np.float32)
                        for kr in range(plan.kc):
                            if cs0 + c0 + kr < c:
                                row = w_flat[tap * c + cs0 + c0 + kr,
                                             col0:col0 + plan.bn]
                                ring[kr, :len(row)] = row
                        acc += a.astype(np.float64) @ ring
                        real = min(plan.kc, c - cs0 - c0)
                        if real > 0:
                            k0 = tap * c + cs0 + c0
                            a_seen[pix[bx][live], k0:k0 + real] = a[live, :real]
            ncol = min(plan.bn, o - col0)
            y[pix[bx][live], col0:col0 + ncol] = acc[live, :ncol]
    return y.reshape(n, oh, ow, o), a_seen


EMULATED = {
    "conv-bench S1 at batch 2": (_geom(2, 32, 32, 3, 64, 3, 1), "float32"),
    "conv-bench S4 at batch 2 (two images a tile)":
        (_geom(2, 8, 8, 128, 256, 3, 1), "bfloat16"),
    "ragged C 3, O 40, odd H and W": (FIXED["ragged C 3, O 40, odd H and W"],
                                      "bfloat16"),
    "ragged C 24, O 40, k5 p2": (FIXED["ragged C 24, O 40, k5 p2"], "float32"),
    "O off the 16-byte grid, p0": (FIXED["O off the 16-byte grid"], "float32"),
    "deep C, sliced halo": (_geom(2, 5, 5, 384, 16, 3, 1), "float32"),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_halo_addressing_reproduces_the_patch_matrix(name):
    g, dtype = EMULATED[name]
    plan = _plan(g, ITEMSIZES[dtype])
    if name.startswith("deep C"):
        assert plan.cs < plan.cp, "the case must walk C in halo slices"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g["n"], g["h"], g["w"], g["c"])).astype(np.float32)
    w = rng.standard_normal((g["k"], g["k"], g["c"], g["o"])).astype(np.float32)
    y, a_seen = _emulate(x, w, g["pad"], plan)
    k_all = g["k"] * g["k"] * g["c"]
    eye = torch.eye(k_all).reshape(g["k"], g["k"], g["c"], k_all)
    p = kernel_ops.conv_gemm_plain(torch.from_numpy(x), eye,
                                   padding=g["pad"]).reshape(-1, k_all)
    # every A element the lanes read is P's, and every element of P was read
    np.testing.assert_array_equal(a_seen, p.numpy())
    want = kernel_ops.conv_gemm_plain(torch.from_numpy(x), torch.from_numpy(w),
                                      padding=g["pad"]).numpy()
    assert not np.isnan(y).any(), "an output no block stored"
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_refuses_a_misaligned_view():
    """The CUDA path of conv_gemm plans before it launches: a bf16 x whose
    data starts 2 bytes into its storage with C = 64 raises instead of
    taking the 16-byte copies; the same x, aligned, passes the plan and
    stops only at the device check (these tensors lie on the CPU)."""
    shape = (2, 8, 8, 64)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    base = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    misaligned = base[1:1 + int(np.prod(shape))].view(shape)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel_ops._conv_gemm_cuda(misaligned, w, padding=1)
    aligned = base[:int(np.prod(shape))].view(shape)
    if aligned.data_ptr() % 16 == 0:
        with pytest.raises(ValueError, match="CUDA device"):
            kernel_ops._conv_gemm_cuda(aligned, w, padding=1)
    torch.testing.assert_close(
        kernel_ops.conv_gemm(misaligned, w, padding=1),
        kernel_ops.conv_gemm_plain(misaligned.clone(), w, padding=1))

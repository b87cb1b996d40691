"""The tile plan of the conv weight-gradient kernel K5
(`kernel_ops.conv_dw_plan`, which `kernel_ops.conv_dw` hands to
`csrc/conv_dw.cu`), at reference_cnn's two convs (batch 32, stride 2),
every preset's weight gradients as its training step makes them (recorded
from a CPU step through the kernel backend, at batches 32 and 2048), and
conv-bench's stride-1 rows at batch 128 (vgg_small's and cifar3conv's
layers).

At each, in float32 and bf16, the plan must:
- cover every output (tap, channel, output channel) exactly once with its
  output tiles, and every pixel tile exactly once with its chunks, in
  increasing order (the fixed order of the sum), each pixel tile every
  output pixel once;
- keep the partials' scratch under `_DW_MAX_PARTIAL` floats, the grid
  within its limits and shared memory within 227 KB;
- sum in one pass exactly where a tile's partials are few;
- copy x in 16-byte chunks exactly where C is a multiple of a 16-byte
  chunk, g exactly where O is, and refuse a misaligned operand there.

Then a numpy emulation of the kernel at small geometries, stride 2
included: per output tile and chunk, each pixel tile's x halo and g tile
as the kernel loads them, every tap's x rows read at the kernel's
addresses (the row's halo pixel plus the tap's shift), which must equal
the windows `conv_dw_plain` multiplies, and the partial sums added in
chunk order, which must equal `conv_dw_plain`'s dw. CPU only: the kernel
itself is held to its plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_cuda_cnn_tpu_torch.bench.conv_shapes import SHAPES
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import MODEL_PRESETS, get_model
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

SMEM_LIMIT = 227 * 1024
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535
ALIGNED = 0x7F0000000100
ITEMSIZES = {"float32": 4, "bfloat16": 2}
BATCHES = (32, 2048)


def _geom(n, h, w, c, o, k, stride, pad) -> dict:
    return dict(n=n, h=h, w=w, c=c, o=o, k=k, stride=stride, pad=pad)


FIXED = {
    "reference_cnn conv1": _geom(32, 28, 28, 1, 16, 3, 2, 1),
    "reference_cnn conv2": _geom(32, 14, 14, 16, 32, 3, 2, 1),
    **{f"conv-bench {n}x{h}x{w}x{c}->{o}": _geom(n, h, w, c, o, k, s, p)
       for (n, h, w, c, k, o, s, p) in SHAPES if s == 1},
    "ragged C 3, O 40, odd H and W": _geom(3, 9, 11, 3, 40, 3, 1, 1),
    "k5, 25 taps in three tiles": _geom(2, 14, 14, 6, 16, 5, 1, 0),
}


def _out_hw(g: dict) -> tuple[int, int]:
    return kernel_ops.conv_out_hw(g["h"], g["w"], g["k"], g["k"], g["stride"],
                                  (g["pad"],) * 4, 1)


def _plan(g: dict, itemsize: int, x_ptr: int = ALIGNED,
          g_ptr: int = ALIGNED) -> kernel_ops.ConvDwPlan:
    oh, ow = _out_hw(g)
    return kernel_ops.conv_dw_plan(g["n"], g["h"], g["w"], g["c"], g["o"],
                                   g["k"], g["k"], oh, ow, g["stride"],
                                   itemsize=itemsize, x_ptr=x_ptr, g_ptr=g_ptr)


def _tile_pixels(plan, n, oh, ow):
    """(pixel tile, row) -> output pixel index or -1, as the kernel's tile
    decode and row decode map them."""
    tiles_x, tiles_y = -(-ow // plan.tw), -(-oh // plan.th)
    ntiles = -(-n // plan.ni) * tiles_y * tiles_x
    t = np.arange(ntiles)[:, None]
    r = np.arange(kernel_ops._TILE_PIXELS)[None, :]
    ox0, oy0 = (t % tiles_x) * plan.tw, (t // tiles_x % tiles_y) * plan.th
    n0 = t // tiles_x // tiles_y * plan.ni
    per = plan.th * plan.tw
    nn, oy, ox = n0 + r // per, oy0 + r % per // plan.tw, ox0 + r % per % plan.tw
    ok = (r < plan.ni * per) & (nn < n) & (oy < oh) & (ox < ow)
    return np.where(ok, (nn * oh + oy) * ow + ox, -1)


def _output_tiles(plan, taps_all, c, o):
    """Output tile index (blockIdx.y) -> (first tap, taps, channel base,
    column base), as the kernel decodes it."""
    nslices, nobl = plan.cp // plan.cs, -(-o // plan.bn)
    out = []
    for y in range(plan.grid_n):
        ob, rest = y % nobl, y // nobl
        tap0 = rest // nslices * plan.taps
        out.append((tap0, min(plan.taps, taps_all - tap0),
                    rest % nslices * plan.cs, ob * plan.bn))
    return out


def _check_plan(g: dict, itemsize: int) -> kernel_ops.ConvDwPlan:
    n, c, o, k = g["n"], g["c"], g["o"], g["k"]
    oh, ow = _out_hw(g)
    plan = _plan(g, itemsize)
    assert plan.ni * plan.th * plan.tw <= kernel_ops._TILE_PIXELS
    assert plan.ni <= n and plan.th <= oh and plan.tw <= ow
    assert (plan.cs, plan.bn) in (((16, 64),) if itemsize == 2
                                  else ((16, 64), (4, 32)))
    assert plan.cp == -(-c // plan.cs) * plan.cs
    assert plan.taps == min(k * k, 9)
    # the output tiles cover every (tap, c, o) once
    cover = np.zeros((k * k, c, o), np.int64)
    for tap0, tg, c0, o0 in _output_tiles(plan, k * k, c, o):
        assert tg >= 1 and c0 < c and o0 < o
        cover[tap0:tap0 + tg, c0:c0 + plan.cs, o0:o0 + plan.bn] += 1
    assert (cover == 1).all()
    # the pixel tiles cover every output pixel once; the chunks cover the
    # pixel tiles once, as increasing runs, in chunk order
    pix = _tile_pixels(plan, n, oh, ow)
    counts = np.bincount(pix[pix >= 0], minlength=n * oh * ow)
    assert counts.shape == (n * oh * ow,) and (counts == 1).all()
    ntiles = pix.shape[0]
    runs = [range(b * plan.tiles_per_chunk,
                  min((b + 1) * plan.tiles_per_chunk, ntiles))
            for b in range(plan.grid_m)]
    assert all(len(r) for r in runs)
    assert [t for r in runs for t in r] == list(range(ntiles))
    assert 1 <= plan.grid_m <= GRID_X_MAX and 1 <= plan.grid_n <= GRID_Y_MAX
    nout = k * k * c * o
    assert plan.scratch == (plan.grid_m * nout if plan.grid_m > 1 else 0)
    assert plan.scratch <= kernel_ops._DW_MAX_PARTIAL
    tile_out = plan.taps * min(plan.cs, c) * min(plan.bn, o)
    assert plan.one_pass == (plan.grid_m * tile_out
                             <= kernel_ops._DW_ONE_PASS_MAX)
    chunk = 16 // itemsize
    hh = g["stride"] * (plan.th - 1) + k
    hw = g["stride"] * (plan.tw - 1) + k
    stages = 3 if itemsize == 2 else 2
    assert plan.smem_bytes == stages * itemsize * (
        plan.ni * hh * hw * (plan.cs + chunk)
        + kernel_ops._TILE_PIXELS * (plan.bn + chunk)) + 4 * (
            2 * 128 + -(-(plan.ni * hh * hw) // 4) * 4)
    assert hh < 4096 and hw < 4096
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.x_vec == (c % chunk == 0) and plan.g_vec == (o % chunk == 0)
    for x_ptr, g_ptr, copied in ((ALIGNED + itemsize, ALIGNED, plan.x_vec),
                                 (ALIGNED, ALIGNED + 8, plan.g_vec)):
        if copied:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _plan(g, itemsize, x_ptr, g_ptr)
        else:
            assert _plan(g, itemsize, x_ptr, g_ptr) == plan
    return plan


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("name", sorted(FIXED))
def test_plan_at_fixed_geometries(name, dtype):
    _check_plan(FIXED[name], ITEMSIZES[dtype])


def test_reference_cnn_sums_in_one_launch_and_deep_shapes_fill_the_card():
    """reference_cnn's two weight gradients sum their chunks in the
    kernel (one launch); conv-bench's deep rows get two blocks an SM."""
    for name in ("reference_cnn conv1", "reference_cnn conv2"):
        for itemsize in ITEMSIZES.values():
            plan = _plan(FIXED[name], itemsize)
            assert plan.grid_m > 1 and plan.one_pass
    for (n, h, w, c, k, o, s, p) in SHAPES:
        if s == 1 and c >= 64:
            for itemsize in ITEMSIZES.values():
                plan = _plan(_geom(n, h, w, c, o, k, s, p), itemsize)
                assert plan.grid_m * plan.grid_n >= 2 * kernel_ops._SMS * 0.9


def _preset_weight_grads(preset: str) -> list[dict]:
    """The K5 geometries of one training step of `preset` on the kernel
    backend (batch 2), recorded from the plain version the CPU wrapper
    calls."""
    calls = []
    plain = kernel_ops.conv_dw_plain

    def record(x, g, *, stride, padding, kh, kw):
        assert kh == kw
        n, h, w, c = x.shape
        calls.append(_geom(n, h, w, c, g.shape[3], kh, stride, padding))
        return plain(x, g, stride=stride, padding=padding, kh=kh, kw=kw)

    model = get_model(preset)
    params = model.init(prng.key(0),
                        get_initializer("normal"))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.rand(2, *model.input_shape)
    kernel_ops.conv_dw_plain = record
    try:
        loss = model.apply(params, x, backend="cuda").square().mean()
        torch.autograd.grad(loss, leaves)
    finally:
        kernel_ops.conv_dw_plain = plain
    return calls


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_plan_at_every_preset_weight_gradient(preset):
    calls = _preset_weight_grads(preset)
    assert calls
    for g in calls:
        for batch in BATCHES:
            for itemsize in ITEMSIZES.values():
                _check_plan({**g, "n": batch}, itemsize)


def _emulate(x: np.ndarray, gy: np.ndarray, g: dict, plan):
    """The kernel's arithmetic in numpy: per output tile, per chunk, per
    pixel tile the halo and g tile as loaded, every tap's x rows at the
    kernel's addresses; partials summed in chunk order. Returns (dw, every
    (tap, output pixel, channel) value a tap's rows gave)."""
    n, h, w, c = x.shape
    _, oh, ow, o = gy.shape
    k, s, pad = g["k"], g["stride"], g["pad"]
    hh, hw = s * (plan.th - 1) + k, s * (plan.tw - 1) + k
    tiles_x, tiles_y = -(-ow // plan.tw), -(-oh // plan.th)
    pix = _tile_pixels(plan, n, oh, ow)
    ntiles = pix.shape[0]
    per = plan.th * plan.tw
    rows = np.arange(kernel_ops._TILE_PIXELS)
    live_rows = rows < plan.ni * per
    pbt = np.where(live_rows, (rows // per * hh + rows % per // plan.tw * s) * hw
                   + rows % per % plan.tw * s, 0)
    hp = np.arange(plan.ni * hh * hw)
    hi, hy, hx = hp // (hh * hw), hp % (hh * hw) // hw, hp % hw
    g_flat = gy.reshape(-1, o)
    x_seen = np.full((k * k, n * oh * ow, c), np.nan, np.float32)
    dw = np.zeros((k * k, c, o), np.float32)
    for tap0, tg, c0, o0 in _output_tiles(plan, k * k, c, o):
        parts = []
        for b in range(plan.grid_m):
            acc = np.zeros((tg, plan.cs, plan.bn), np.float64)
            for t in range(b * plan.tiles_per_chunk,
                           min((b + 1) * plan.tiles_per_chunk, ntiles)):
                ox0 = (t % tiles_x) * plan.tw
                oy0 = (t // tiles_x % tiles_y) * plan.th
                n0 = t // tiles_x // tiles_y * plan.ni
                nn = n0 + hi
                iy, ix = oy0 * s - pad + hy, ox0 * s - pad + hx
                inside = (nn < n) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                halo = np.zeros((len(hp), plan.cs), np.float32)
                for cc in range(min(plan.cs, c - c0)):
                    halo[inside, cc] = x[nn[inside], iy[inside], ix[inside],
                                         c0 + cc]
                gt = np.zeros((kernel_ops._TILE_PIXELS, plan.bn), np.float32)
                live = pix[t] >= 0
                ncol = min(plan.bn, o - o0)
                gt[live, :ncol] = g_flat[pix[t][live], o0:o0 + ncol]
                for tt in range(tg):
                    ky, kx = divmod(tap0 + tt, k)
                    a = halo[pbt + ky * hw + kx]        # (pixels, cs)
                    acc[tt] += a.T.astype(np.float64) @ gt
                    nc = min(plan.cs, c - c0)
                    x_seen[tap0 + tt, pix[t][live], c0:c0 + nc] = a[live, :nc]
            parts.append(acc.astype(np.float32))
        total = np.zeros_like(parts[0])
        for p in parts:               # chunk order
            total += p
        nc, ncol = min(plan.cs, c - c0), min(plan.bn, o - o0)
        dw[tap0:tap0 + tg, c0:c0 + nc, o0:o0 + ncol] = total[:, :nc, :ncol]
    return dw.reshape(k, k, c, o), x_seen


EMULATED = {
    "reference_cnn conv1 at batch 2, stride 2": (_geom(2, 28, 28, 1, 16, 3, 2, 1),
                                                 "float32"),
    "reference_cnn conv2 at batch 3, stride 2": (_geom(3, 14, 14, 16, 32, 3, 2, 1),
                                                 "bfloat16"),
    "ragged stride 2, odd H and W": (_geom(2, 9, 11, 3, 40, 3, 2, 1), "float32"),
    "ragged C 3, O 40, stride 1": (FIXED["ragged C 3, O 40, odd H and W"],
                                   "bfloat16"),
    "k5, 25 taps": (FIXED["k5, 25 taps in three tiles"], "float32"),
    "deep float32 tile, stride 1": (_geom(2, 8, 8, 32, 64, 3, 1, 1), "float32"),
    "many chunks, stride 1": (_geom(16, 8, 8, 8, 8, 3, 1, 1), "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_halo_addressing_reproduces_the_windows(name):
    g, dtype = EMULATED[name]
    plan = _plan(g, ITEMSIZES[dtype])
    rng = np.random.default_rng(0)
    oh, ow = _out_hw(g)
    x = rng.standard_normal((g["n"], g["h"], g["w"], g["c"])).astype(np.float32)
    gy = rng.standard_normal((g["n"], oh, ow, g["o"])).astype(np.float32)
    dw, x_seen = _emulate(x, gy, g, plan)
    k, s, p = g["k"], g["stride"], g["pad"]
    # the windows conv_dw_plain multiplies, tap by tap
    xp = F.pad(torch.from_numpy(x), (0, 0, p, p, p, p))
    for tap in range(k * k):
        ky, kx = divmod(tap, k)
        win = xp[:, ky:ky + s * (oh - 1) + 1:s, kx:kx + s * (ow - 1) + 1:s]
        np.testing.assert_array_equal(x_seen[tap],
                                      win.reshape(-1, g["c"]).numpy())
    want = kernel_ops.conv_dw_plain(torch.from_numpy(x), torch.from_numpy(gy),
                                    stride=s, padding=p, kh=k, kw=k).numpy()
    np.testing.assert_allclose(dw, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if name.startswith("many chunks"):
        assert plan.grid_m > 1


def test_wrapper_refuses_a_misaligned_view():
    """The CUDA path of conv_dw plans before it launches: a bf16 x whose
    data starts 2 bytes into its storage with C = 16 raises instead of
    taking the 16-byte copies; the same x, aligned, stops only at the
    device check (these tensors lie on the CPU)."""
    shape = (2, 8, 8, 16)
    g = torch.zeros(2, 8, 8, 32, dtype=torch.bfloat16)
    base = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    misaligned = base[1:1 + int(np.prod(shape))].view(shape)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    kw = dict(stride=1, padding=1, kh=3, kw=3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel_ops._conv_dw_cuda(misaligned, g, **kw)
    aligned = base[:int(np.prod(shape))].view(shape)
    if aligned.data_ptr() % 16 == 0:
        with pytest.raises(ValueError, match="CUDA device"):
            kernel_ops._conv_dw_cuda(aligned, g, **kw)
    torch.testing.assert_close(
        kernel_ops.conv_dw(misaligned, g, **kw),
        kernel_ops.conv_dw_plain(misaligned.clone(), g, **kw))

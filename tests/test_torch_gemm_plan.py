"""The tile and split plan of the GEMM kernel K3 (`kernel_ops.gemm_plan`,
which `kernel_ops.gemm` hands to `csrc/gemm.cu`), at reference_cnn's nine
batch-32 step products and three eval products (batch 2,048), and at
every preset's dense products as its training step makes them (recorded
from a CPU step through the kernel backend, at batch 32 and, for the
forwards, at the eval batch of 2,048).

At each, in float32 and bf16, the plan must:
- cover every output exactly once with its tiles, and K exactly once
  with its splits, as increasing runs of whole 32-deep slices (the fixed
  order of the split sum);
- keep the grid within its limits, the block's static shared memory
  under 48 KB, and the split's scratch and counters sized to the grid;
- put about 100 blocks on the card wherever the product has that many
  tile-slices, and otherwise as many as it has;
- copy an operand in 16-byte chunks exactly where its stored rows are
  whole chunks, and refuse a misaligned operand there.

Then a numpy emulation of the kernel at small geometries, each (ta, tb):
every block's ring stages loaded in the stored layouts with the
zero-fill, the bf16 path's `ldmatrix` lane addresses (plain or
`.trans`) and the m16n8k16 fragments they give, the float32 path's
register-tile reads, each thread's or lane's outputs, and the split
partials summed in split order, which must equal `gemm_plain`. CPU only:
the kernel itself is held to its plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import MODEL_PRESETS, get_model
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

STATIC_SMEM_LIMIT = 48 * 1024
GRID_LIMIT = 65535
ALIGNED = 0x7F0000000100
ITEMSIZES = {"float32": 4, "bfloat16": 2}
BATCH, EVAL_BATCH = 32, 2048
BN, BK = kernel_ops._K3_BN, kernel_ops._K3_BK

# reference_cnn (fc 1568 -> 200 -> 200 -> 10): (m, n, k, ta, tb)
STEP = {
    "fc1 forward": (32, 200, 1568, False, False),
    "fc2 forward": (32, 200, 200, False, False),
    "fc3 forward": (32, 10, 200, False, False),
    "fc1 input grad": (32, 1568, 200, False, True),
    "fc2 input grad": (32, 200, 200, False, True),
    "fc3 input grad": (32, 200, 10, False, True),
    "fc1 weight grad": (1568, 200, 32, True, False),
    "fc2 weight grad": (200, 200, 32, True, False),
    "fc3 weight grad": (200, 10, 32, True, False),
    "fc1 eval forward": (2048, 200, 1568, False, False),
    "fc2 eval forward": (2048, 200, 200, False, False),
    "fc3 eval forward": (2048, 10, 200, False, False),
}


def _plan(m, n, k, ta, tb, itemsize, a_ptr=ALIGNED, b_ptr=ALIGNED):
    return kernel_ops.gemm_plan(m, n, k, trans_a=ta, trans_b=tb,
                                itemsize=itemsize, a_ptr=a_ptr, b_ptr=b_ptr)


def _splits(plan, k):
    """The K run [k0, k1) of each split, in split order."""
    return [(z * plan.kchunk, min(k, (z + 1) * plan.kchunk))
            for z in range(plan.splits)]


def _check_plan(m, n, k, ta, tb, itemsize) -> kernel_ops.GemmPlan:
    plan = _plan(m, n, k, ta, tb, itemsize)
    cap = 16
    while cap < min(m, 64):
        cap *= 2
    assert plan.bm in (16, 32, 64) and plan.bm <= cap
    # tiles cover every output once
    assert plan.grid_m == -(-m // plan.bm) and plan.grid_n == -(-n // BN)
    cover = np.zeros((plan.grid_m * plan.bm, plan.grid_n * BN), np.int64)
    for by in range(plan.grid_m):
        for bx in range(plan.grid_n):
            cover[by * plan.bm:(by + 1) * plan.bm, bx * BN:(bx + 1) * BN] += 1
    assert (cover == 1).all()
    # splits cover K once, as increasing runs of whole slices
    assert plan.kchunk % BK == 0 and plan.kchunk >= BK
    runs = _splits(plan, k)
    assert all(k0 < k1 for k0, k1 in runs)
    assert [i for k0, k1 in runs for i in range(k0, k1)] == list(range(k))
    assert 1 <= plan.grid_m <= GRID_LIMIT and 1 <= plan.splits <= GRID_LIMIT
    # blocks: about 100 where the product has that many tile-slices
    slices = -(-k // BK)
    blocks = plan.grid_m * plan.grid_n * plan.splits
    most = -(-m // 16) * plan.grid_n * slices   # at bm 16, one slice a split
    if most >= kernel_ops._K3_MIN_BLOCKS:
        assert blocks >= 0.9 * kernel_ops._K3_MIN_BLOCKS
    else:
        assert plan.bm == 16 and plan.splits == slices and blocks == most
    assert blocks <= 2 * kernel_ops._SMS or plan.splits == 1
    # scratch, counters, threads, shared memory
    split = plan.splits > 1
    assert plan.scratch == (plan.splits * m * n if split else 0)
    assert plan.counters == (plan.grid_m * plan.grid_n if split else 0)
    assert plan.threads == (128 if itemsize == 2 else plan.bm * BN // 16)
    pad = 16 // itemsize
    a = BK * (plan.bm + pad) if ta else plan.bm * (BK + pad)
    b = BN * (BK + pad) if tb else BK * (BN + pad)
    stages = 4 if itemsize == 2 else 3
    assert plan.smem_bytes == stages * itemsize * (a + b)
    assert 0 < plan.smem_bytes + 4 <= STATIC_SMEM_LIMIT
    # 16-byte copies exactly where the stored rows are whole chunks
    assert plan.a_vec == ((m if ta else k) % pad == 0)
    assert plan.b_vec == ((k if tb else n) % pad == 0)
    for a_ptr, b_ptr, copied in ((ALIGNED + itemsize, ALIGNED, plan.a_vec),
                                 (ALIGNED, ALIGNED + 8, plan.b_vec)):
        if copied:
            with pytest.raises(ValueError, match="16-byte aligned"):
                _plan(m, n, k, ta, tb, itemsize, a_ptr, b_ptr)
        else:
            assert _plan(m, n, k, ta, tb, itemsize, a_ptr, b_ptr) == plan
    return plan


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("name", sorted(STEP))
def test_plan_at_reference_cnn_products(name, dtype):
    _check_plan(*STEP[name], ITEMSIZES[dtype])


@pytest.mark.parametrize("m,n,k", [(32, 200, 1568), (32, 1568, 200),
                                   (1568, 200, 32), (2048, 10, 200),
                                   (32, 10, 200), (5, 3, 7)])
def test_gemm_split_covers_k(m, n, k):
    plan = _plan(m, n, k, False, False, 4)
    kchunk, splits = plan.kchunk, plan.splits
    assert kchunk % 32 == 0 and splits >= 1
    assert kchunk * splits >= k > kchunk * (splits - 1)
    if (m, n, k) == (32, 200, 1568):
        assert splits > 1   # fc1's forward: 7 column tiles over K = 1,568
    if (m, n, k) in ((32, 1568, 200), (2048, 10, 200), (32, 10, 200)):
        assert splits > 1   # K = 200 under too few tiles is split as well
    if (m, n, k) in ((1568, 200, 32), (5, 3, 7)):
        assert splits == 1  # one slice of K


def test_step_products_fill_the_card():
    """The nine step products and three eval products put about 100 to
    264 blocks on the card, but fc3's (N = 10 or K = 10 over 32 rows),
    whose 13-14 tile-slices all run at once."""
    for name, (m, n, k, ta, tb) in STEP.items():
        for itemsize in ITEMSIZES.values():
            plan = _plan(m, n, k, ta, tb, itemsize)
            blocks = plan.grid_m * plan.grid_n * plan.splits
            if name.startswith("fc3") and "eval" not in name:
                assert 13 <= blocks <= 14, name
            else:
                assert 90 <= blocks <= 2 * kernel_ops._SMS, (name, blocks)


def _preset_products(preset: str) -> list[tuple]:
    """K3's (m, n, k, ta, tb) in one training step of `preset` on the
    kernel backend at batch 3, recorded from the plain version the CPU
    wrapper calls."""
    calls = []
    plain = kernel_ops.gemm_plain

    def record(a, b, *, trans_a=False, trans_b=False, bias=None):
        m, k = a.shape[::-1] if trans_a else a.shape
        n = b.shape[0] if trans_b else b.shape[1]
        calls.append((m, n, k, trans_a, trans_b))
        return plain(a, b, trans_a=trans_a, trans_b=trans_b, bias=bias)

    model = get_model(preset)
    params = model.init(prng.key(0),
                        get_initializer("normal"))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.rand(3, *model.input_shape)
    kernel_ops.gemm_plain = record
    try:
        loss = model.apply(params, x, backend="cuda").square().mean()
        torch.autograd.grad(loss, leaves)
    finally:
        kernel_ops.gemm_plain = plain
    return calls


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_plan_at_every_preset_dense_product(preset):
    calls = _preset_products(preset)
    assert calls and len(calls) % 3 == 0
    for m, n, k, ta, tb in calls:
        # the batch is the rows of the forward and the input gradient,
        # and the depth of the weight gradient; no width is 3
        dims = [n, k] if not ta else [m, n]
        assert 3 not in dims and (k if ta else m) == 3
        shapes = ([(m, n, BATCH, ta, tb)] if ta else
                  [(BATCH, n, k, ta, tb)]
                  + ([(EVAL_BATCH, n, k, ta, tb)] if not tb else []))
        for shape in shapes:
            for itemsize in ITEMSIZES.values():
                _check_plan(*shape, itemsize)


# ---------------------------------------------------------------------------
# The kernel's arithmetic in numpy
# ---------------------------------------------------------------------------


def _stage(src, r0, rend, c0, cend, rows, cols, pad):
    """A stored matrix's rows r0.. (below rend) x columns c0.. (below
    cend) in a [rows][cols + pad] stage, zero elsewhere (the zero-fill)."""
    st = np.zeros((rows, cols + pad), np.float32)
    r1, c1 = min(rend, r0 + rows), min(cend, c0 + cols)
    if r1 > r0 and c1 > c0:
        st[:r1 - r0, :c1 - c0] = src[r0:r1, c0:c1]
    return st


def _ldmatrix(st, rows, cols, trans, nmat, width):
    """`ldmatrix` (x`nmat`) from a stage: lane 8 j + i gives the address
    (rows, cols) of row i of matrix j, 8 elements that must lie inside the
    stage's unpadded width; lane l receives, of each matrix, row l / 4 at
    columns 2 (l % 4) .. +1, or transposed column l / 4 at rows 2 (l % 4)
    .. +1. Returns [matrix][lane][2]."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((nmat, 32, 2), np.float32)
    for j in range(nmat):
        r, c = rows[8 * j:8 * j + 8], cols[8 * j:8 * j + 8]
        assert (r >= 0).all() and (r < st.shape[0]).all()
        assert (c >= 0).all() and (c + 8 <= width).all() and (c % 8 == 0).all()
        mat = np.stack([st[ri, ci:ci + 8] for ri, ci in zip(r, c)])
        if trans:
            out[j] = np.stack([mat[2 * t, g], mat[2 * t + 1, g]], -1)
        else:
            out[j] = np.stack([mat[g, 2 * t], mat[g, 2 * t + 1]], -1)
    return out


def _frag_a(regs):
    """The 16 x 16 A of mma.m16n8k16 from its four registers a0..a3."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    a = np.full((16, 16), np.nan, np.float32)
    for j, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        a[g + dr, 2 * t + dc] = regs[j, :, 0]
        a[g + dr, 2 * t + dc + 1] = regs[j, :, 1]
    assert not np.isnan(a).any()
    return a


def _frag_b(b0, b1):
    """The 16 x 8 (col-major) B of mma.m16n8k16 from b0, b1."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    b = np.full((16, 8), np.nan, np.float32)
    for reg, dk in ((b0, 0), (b1, 8)):
        b[2 * t + dk, g] = reg[:, 0]
        b[2 * t + dk + 1, g] = reg[:, 1]
    assert not np.isnan(b).any()
    return b


def _block_bf16(As, Bs, ta, tb, bm, acc, owner):
    """One slice of the bf16 path: per warp and k16 step, the A fragment
    and the B fragments by `ldmatrix` at the kernel's lane addresses, the
    products into the warp's accumulators; `owner` counts the (warp,
    lane, register) that store each tile output."""
    lane = np.arange(32)
    wmn = min(bm // 16, 4)
    wc = BN // (4 // wmn)
    nt_count = wc // 8
    a_width = bm if ta else BK
    b_width = BK if tb else BN
    for warp in range(4):
        wm, wn = warp % wmn, warp // wmn
        for k16 in range(0, BK, 16):
            if ta:
                regs = _ldmatrix(As, k16 + (lane >> 4) * 8 + (lane & 7),
                                 wm * 16 + ((lane >> 3) & 1) * 8, True, 4,
                                 a_width)
            else:
                regs = _ldmatrix(As, wm * 16 + (lane & 15),
                                 k16 + (lane >> 4) * 8, False, 4, a_width)
            a = _frag_a(regs)
            for p in range((nt_count + 1) // 2):
                nb = wn * wc + 16 * p
                j = lane >> 3
                if tb:
                    rows = nb + (j >> 1) * 8 + (lane & 7)
                    cols = k16 + (j & 1) * 8
                else:
                    rows = k16 + (j & 1) * 8 + (lane & 7)
                    cols = nb + (j >> 1) * 8
                nmat = 2 if nt_count == 1 else 4
                b = _ldmatrix(Bs, rows, cols, not tb, nmat, b_width)
                for half in range(nmat // 2):
                    nt = 2 * p + half
                    d = a @ _frag_b(b[2 * half], b[2 * half + 1])
                    acc[wm * 16:wm * 16 + 16,
                        wn * wc + 8 * nt:wn * wc + 8 * nt + 8] += d
    if owner is not None:
        for warp in range(4):
            wm, wn = warp % wmn, warp // wmn
            for i in range(nt_count):
                for e in range(4):
                    r = wm * 16 + (lane >> 2) + 8 * (e >> 1)
                    c = wn * wc + 8 * i + 2 * (lane & 3) + (e & 1)
                    np.add.at(owner, (r, c), 1)


def _block_f32(As, Bs, ta, tb, bm, acc, owner):
    """One slice of the float32 path: thread (tm, tn) reads four float4
    of A and four of B per 4 steps of k at the kernel's addresses and
    holds 4 x 4 outputs (columns tn + 8 c with tb, else 4 tn + c)."""
    tid = np.arange(bm * BN // 16)
    tn, tm = tid % (BN // 4), tid // (BN // 4)
    cols = (tn[:, None] + 8 * np.arange(4) if tb
            else 4 * tn[:, None] + np.arange(4))
    rows = 4 * tm[:, None] + np.arange(4)
    part = np.zeros((len(tid), 4, 4), np.float32)
    for kk in range(0, BK, 4):
        av = np.zeros((len(tid), 4, 4), np.float32)  # [thread][row][k]
        bv = np.zeros((len(tid), 4, 4), np.float32)  # [thread][k][col]
        for u in range(4):
            if ta:
                av[:, :, u] = As[kk + u][4 * tm[:, None] + np.arange(4)]
            else:
                av[:, u, :] = As[4 * tm + u][:, kk:kk + 4]
            if tb:
                bv[:, :, u] = Bs[tn + 8 * u][:, kk:kk + 4]
            else:
                bv[:, u, :] = Bs[kk + u][4 * tn[:, None] + np.arange(4)]
        part += np.einsum("tru,tuc->trc", av, bv)
    for t in range(len(tid)):
        acc[np.ix_(rows[t], cols[t])] += part[t]
        if owner is not None:
            np.add.at(owner, (rows[t][:, None], cols[t][None, :]), 1)


def _emulate(a, b, ta, tb, plan, itemsize):
    """The kernel's arithmetic over every block and split; partials summed
    in split order."""
    m, k = a.shape[::-1] if ta else a.shape
    n = b.shape[0] if tb else b.shape[1]
    pad = 16 // itemsize
    bm = plan.bm
    parts = np.zeros((plan.splits, m, n), np.float32)
    block = _block_bf16 if itemsize == 2 else _block_f32
    for z, (kbeg, kend) in enumerate(_splits(plan, k)):
        for by in range(plan.grid_m):
            for bx in range(plan.grid_n):
                m0, n0 = by * bm, bx * BN
                acc = np.zeros((bm, BN), np.float32)
                owner = np.zeros((bm, BN), np.int64)
                for k0 in range(kbeg, kend, BK):
                    As = (_stage(a, k0, kend, m0, m, BK, bm, pad) if ta
                          else _stage(a, m0, m, k0, kend, bm, BK, pad))
                    Bs = (_stage(b, n0, n, k0, kend, BN, BK, pad) if tb
                          else _stage(b, k0, kend, n0, n, BK, BN, pad))
                    block(As, Bs, ta, tb, bm, acc,
                          owner if k0 == kbeg else None)
                    if k0 == kbeg:
                        assert (owner == 1).all()
                mr, nr = min(bm, m - m0), min(BN, n - n0)
                parts[z, m0:m0 + mr, n0:n0 + nr] = acc[:mr, :nr]
    total = np.zeros((m, n), np.float32)
    for p in parts:       # split order
        total += p
    return total


EMULATED = {
    # (m, n, k, ta, tb, dtype): every layout, both paths, ragged edges,
    # split and unsplit, each tile size
    "forward, split, bm 16": (40, 40, 100, False, False, "bfloat16"),
    "forward, split, bm 16, f32": (40, 40, 100, False, False, "float32"),
    "forward, N 10 element-wise": (20, 10, 72, False, False, "float32"),
    "input grad tb, bm 32": (32, 72, 64, False, True, "bfloat16"),
    "input grad tb, K 10": (24, 40, 10, False, True, "float32"),
    "weight grad ta, bm 64": (136, 40, 24, True, False, "bfloat16"),
    "weight grad ta, f32": (72, 40, 24, True, False, "float32"),
    "both transposed": (36, 33, 50, True, True, "bfloat16"),
    "both transposed, f32": (36, 33, 50, True, True, "float32"),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_kernel_equals_gemm_plain(name):
    m, n, k, ta, tb, dtype = EMULATED[name]
    itemsize = ITEMSIZES[dtype]
    plan = _plan(m, n, k, ta, tb, itemsize)
    rng = np.random.default_rng(0)
    # values exact in bf16, so both paths see the same inputs
    a = torch.from_numpy(rng.standard_normal((k, m) if ta else (m, k))
                         .astype(np.float32)).bfloat16().float().numpy()
    b = torch.from_numpy(rng.standard_normal((n, k) if tb else (k, n))
                         .astype(np.float32)).bfloat16().float().numpy()
    got = _emulate(a, b, ta, tb, plan, itemsize)
    want = kernel_ops.gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 trans_a=ta, trans_b=tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if name.startswith("forward, split"):
        assert plan.splits > 1


def test_wrapper_refuses_a_misaligned_view():
    """The CUDA path of gemm plans before it launches: a bf16 A whose data
    starts 2 bytes into its storage with K = 64 raises instead of taking
    the 16-byte copies; the same A, aligned, stops only at the device
    check (these tensors lie on the CPU)."""
    b = torch.zeros(64, 32, dtype=torch.bfloat16)
    base = torch.zeros(16 * 64 + 8, dtype=torch.bfloat16)
    misaligned = base[1:1 + 16 * 64].view(16, 64)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    kw = dict(trans_a=False, trans_b=False, bias=None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel_ops._gemm_cuda(misaligned, b, **kw)
    aligned = base[:16 * 64].view(16, 64)
    if aligned.data_ptr() % 16 == 0:
        with pytest.raises(ValueError, match="CUDA device"):
            kernel_ops._gemm_cuda(aligned, b, **kw)
    torch.testing.assert_close(kernel_ops.gemm(misaligned, b),
                               kernel_ops.gemm_plain(misaligned.clone(), b))

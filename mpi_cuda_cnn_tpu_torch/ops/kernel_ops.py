"""The CNN's hand-written CUDA kernels and the autograd functions over
them (counterpart of the reference's `ops/pallas_ops.py` and
`ops/pallas_conv_gemm.py`).

Four kernels, each under `csrc/` with a plain PyTorch version beside it,
each taking float32 or bfloat16 (every operand of one call in one type),
accumulating in float32 and rounding once to that type at the store:

- K3 `gemm` (`csrc/gemm.cu`): op(A) @ op(B) [+ bias], either operand
  read transposed in place (bf16 on the tensor cores, float32 on FMA),
  K split across blocks and summed in a fixed order in the same launch,
  as `gemm_plan` picks. Replaces `_matmul`.
- K4 `conv_direct` (`csrc/conv_direct.cu`): a direct NHWC/HWIO conv with
  stride, per-side padding, input dilation and a weight flip as
  arguments, run as an implicit GEMM (bf16 on the tensor cores, float32
  on FMA) whose tiles `conv_direct_plan` picks. Replaces `_conv1` with
  its phase split (`_conv_forward`), and is also the transposed conv of
  the input gradient (K4').
- K5 `conv_dw` (`csrc/conv_dw.cu`): the conv weight gradient as the
  transposed product dw = P^T g over pixel chunks (bf16 on the tensor
  cores), summed across chunks in a fixed order, whose tiles
  `conv_dw_plan` picks. Replaces `_conv1_dw`/`_conv_dw`.
- K6 `conv_gemm` (`csrc/conv_gemm.cu`): the stride-1 implicit-GEMM conv
  over one halo tile of x in shared memory, the patch matrix never
  stored (bf16 on the tensor cores), whose tiles `conv_gemm_plan` picks.
  Replaces `_conv1_gemm`.

`dense_kernel`, `conv2d_kernel` and `conv2d_gemm_kernel` are the
`torch.autograd.Function`s over them, the twins of `dense_pallas`,
`conv2d_pallas` and `conv2d_pallas_gemm`: dense forward K3 (bias in the
epilogue), backward dx = g @ W^T and dW = x^T @ g on K3 and db = sum(g)
in PyTorch; conv forward K4 (or K6), dx on K4 (only when the input
needs a gradient, so never for the image), dW on K5, the cotangent cast
to the input's type first. Per `reference_cnn` training step that is K3
9 times, K4 3 times and K5 twice; per eval batch K3 3 and K4 2.

Every wrapper takes its plain version for CPU tensors, and only for
them. A CUDA tensor launches the kernel (one count in
`_kernels.launches` per wrapper call that launched) or raises; there is
no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _kernels

_K3_BN = 32           # K3: output columns of a tile
_K3_BK = 32           # K3: depth of a K slice; kchunk is a multiple
_K3_BMS = (64, 32, 16)  # K3: output rows of a tile, largest first
_K3_MIN_BLOCKS = 96   # K3: blocks a tile size must reach to be taken
_K3_BLOCKS = 128      # K3: blocks the K split aims for (132 SMs)
_K3_STAGES = {2: 4, 4: 3}  # K3: K slices in shared memory, by itemsize
_DW_MAX_PARTIAL = 1 << 24  # floats of K5 scratch before chunks grow
_DW_ONE_PASS_MAX = 1 << 17  # K5: partials one block may sum at its end
_DW_MAX_TAPS = 9      # K5: taps of an output tile (its accumulators)
_DW_STAGES = {2: 3, 4: 2}  # K5: pixel tiles in shared memory, by itemsize
_CONV_BM = 128        # K4: output pixels of a block tile (128 threads)
_CONV_MAX_BN = {2: 128, 4: 64}  # K4: widest channel tile, by element size
_CONV_STAGES = 3      # K4: K slices in shared memory
_SMS = 132            # H100 SXM streaming multiprocessors
_SMEM_LIMIT = 227 * 1024    # a block's shared memory on the H100
_TILE_PIXELS = 128    # K5, K6: output pixels of a tile (128 threads)
_GEMM_STAGES = 4      # K6: weight slices in shared memory
_GEMM_STEP_ROWS = {2: 32, 4: 16}  # K6: weight rows a stage holds, by itemsize
_GEMM_SMEM_TARGET = 100 * 1024  # K6: halo slice sized for two blocks an SM
_GEMM_BNS = {2: (64, 128), 4: (32, 64)}  # K6: channel tiles by itemsize


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, *tensors: torch.Tensor) -> int:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    and all are float32 or all bfloat16; returns that type's code."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if t.dtype != dtype or dtype not in _kernels.DTYPE_CODES:
            raise TypeError(f"{name} wants float32 or bfloat16 tensors, all "
                            f"of one type, got {[u.dtype for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return _kernels.DTYPE_CODES[dtype]


# One int32 counter per output tile, per kernel (K1, K3, K5) and device, zero
# between launches: the last block of a tile resets its own, so launches
# of one kernel on one device must not overlap (the port launches on
# PyTorch's current stream only). A buffer only grows, so its address
# stays fixed once it holds the largest grid.
_counters: dict[tuple[str, torch.device], torch.Tensor] = {}


def _counter_buffer(kernel: str, device: torch.device,
                    count: int) -> torch.Tensor:
    buf = _counters.get((kernel, device))
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 256), dtype=torch.int32, device=device)
        _counters[(kernel, device)] = buf
    return buf


# ---------------------------------------------------------------------------
# K3: GEMM
# ---------------------------------------------------------------------------


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
               trans_b: bool = False,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the GEMM kernel: the product in float32
    rounded to a's type, then the bias added in that type (the JAX
    package's `_matmul(x, w) + b`, which rounds twice in bf16)."""
    y = ((a.t() if trans_a else a).float()
         @ (b.t() if trans_b else b).float()).to(a.dtype)
    return y if bias is None else y + bias


class GemmPlan(NamedTuple):
    """K3's launch plan: output tiles of bm x _K3_BN, grid_m x grid_n of
    them, each over `splits` runs of K of `kchunk` (a multiple of
    _K3_BK), so grid_m x grid_n x splits blocks of `threads`; `a_vec`, `b_vec`:
    16-byte copies of A, of B; `scratch` float32 partials and `counters`
    int32 tile counters (both 0 for one split); `smem_bytes` the kernel's
    static shared memory."""
    bm: int
    kchunk: int
    splits: int
    a_vec: bool
    b_vec: bool
    grid_m: int
    grid_n: int
    threads: int
    scratch: int
    counters: int
    smem_bytes: int


def _k3_smem(bm: int, trans_a: bool, trans_b: bool, itemsize: int) -> int:
    """_K3_STAGES[itemsize] stages of the A tile and the B tile, each in
    its stored layout ([m][k] or, transposed, [k][m]; [k][n] or [n][k]),
    every row padded by 16 bytes."""
    pad = 16 // itemsize
    a = _K3_BK * (bm + pad) if trans_a else bm * (_K3_BK + pad)
    b = _K3_BN * (_K3_BK + pad) if trans_b else _K3_BK * (_K3_BN + pad)
    return _K3_STAGES[itemsize] * itemsize * (a + b)


def gemm_plan(m: int, n: int, k: int, *, trans_a: bool, trans_b: bool,
              itemsize: int, a_ptr: int, b_ptr: int) -> GemmPlan:
    """The tile and split plan of `csrc/gemm.cu` for op(A) (m, k) @ op(B)
    (k, n), elements of `itemsize` bytes (4 float32, 2 bf16).

    bm is the largest of _K3_BMS, at most M rounded up to a power of two
    (at least 16), whose tiles times K slices reach _K3_MIN_BLOCKS
    blocks; else 16. Where the tiles alone are fewer than _K3_BLOCKS, K is
    split into runs of whole slices so that about _K3_BLOCKS blocks share
    it (never a run shorter than one slice: a product of few tiles over a
    shallow K, fc3's, stays under it). a_vec (16-byte copies of A) needs
    A's stored rows (k, or m with trans_a) to be whole 16-byte chunks,
    b_vec B's (n, or k with trans_b); where either holds, that operand
    must be 16-byte aligned, else ValueError."""
    if itemsize not in (2, 4):
        raise ValueError(f"gemm_plan: itemsize {itemsize}")
    if min(m, n, k) < 1:
        raise ValueError(f"gemm_plan: empty product {m}x{n}x{k}")
    slices = -(-k // _K3_BK)
    cap = 16
    while cap < min(m, _K3_BMS[0]):
        cap *= 2
    grid_n = -(-n // _K3_BN)
    fits = [bm for bm in _K3_BMS if bm <= cap]
    bm = next((b for b in fits if -(-m // b) * grid_n * slices
               >= _K3_MIN_BLOCKS), fits[-1])
    grid_m = -(-m // bm)
    tiles = grid_m * grid_n
    splits = 1 if tiles >= _K3_BLOCKS else min(slices, -(-_K3_BLOCKS // tiles))
    kchunk = -(-slices // splits) * _K3_BK
    splits = -(-k // kchunk)
    chunk = 16 // itemsize
    a_vec = (m if trans_a else k) % chunk == 0
    b_vec = (k if trans_b else n) % chunk == 0
    _refuse_misaligned("gemm", a=a_ptr if a_vec else None,
                       b=b_ptr if b_vec else None)
    threads = 128 if itemsize == 2 else bm * _K3_BN // 16
    split = splits > 1
    return GemmPlan(bm, kchunk, splits, a_vec, b_vec, grid_m,
                    grid_n, threads, splits * m * n if split else 0,
                    tiles if split else 0,
                    _k3_smem(bm, trans_a, trans_b, itemsize))


def gemm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
         trans_b: bool = False,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """op(a) @ op(b) [+ bias], float32 or bfloat16: a is (M, K), or (K, M)
    with trans_a; b is (K, N), or (N, K) with trans_b; bias (N,). CUDA
    tensors launch `csrc/gemm.cu` (one launch, split or not); CPU tensors
    take `gemm_plain`."""
    if not a.is_cuda:
        return gemm_plain(a, b, trans_a=trans_a, trans_b=trans_b, bias=bias)
    return _gemm_cuda(a, b, trans_a=trans_a, trans_b=trans_b, bias=bias)


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool,
               trans_b: bool, bias: torch.Tensor | None) -> torch.Tensor:
    """gemm's launch: shapes, the plan (which refuses misaligned
    operands), then the device checks and the kernel."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm: want 2-d operands, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    m, k = a.shape[::-1] if trans_a else a.shape
    kb, n = b.shape[::-1] if trans_b else b.shape
    if kb != k or (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"gemm: op(a) {m}x{k}, op(b) {kb}x{n}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    plan = gemm_plan(m, n, k, trans_a=trans_a, trans_b=trans_b,
                     itemsize=a.element_size(), a_ptr=a.data_ptr(),
                     b_ptr=b.data_ptr())
    dtype = _check("gemm", a, b, *(() if bias is None else (bias,)))
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    work = (torch.empty(plan.scratch, dtype=torch.float32, device=a.device)
            if plan.scratch else None)
    counters = (_counter_buffer("gemm", a.device, plan.counters)
                if plan.counters else None)
    err = _kernels.lib("gemm")(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        c.data_ptr(), None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), m, n, k,
        int(trans_a), int(trans_b), plan.bm, plan.kchunk, plan.splits,
        int(plan.a_vec), int(plan.b_vec), dtype, _stream(a))
    _kernels.check("gemm", err)
    _kernels.launches["gemm"] += 1
    return c


class _DenseFn(torch.autograd.Function):
    """Twin of `dense_pallas` (pallas_ops.py:93-116)."""

    @staticmethod
    def forward(ctx, x, w, b):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return gemm(x, w, bias=b.contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = gemm(g, w, trans_b=True) if ctx.needs_input_grad[0] else None
        dw = gemm(x, g, trans_a=True) if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def dense_kernel(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """FC x @ w + b on K3, forward and backward. x (N, d_in), w (d_in,
    d_out), b (d_out,)."""
    return _DenseFn.apply(x, w, b)


# ---------------------------------------------------------------------------
# K4: direct conv (forward and input gradient)
# ---------------------------------------------------------------------------


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                pads: tuple[int, int, int, int], dil: int) -> tuple[int, int]:
    """Output extent of conv_direct: pads = (top, bottom, left, right)
    around the input dilated by `dil`."""
    pt, pb, pl, pr = pads
    oh = ((h - 1) * dil + 1 + pt + pb - kh) // stride + 1
    ow = ((w - 1) * dil + 1 + pl + pr - kw) // stride + 1
    return oh, ow


def _flipped(w: torch.Tensor) -> torch.Tensor:
    """The transposed conv's weights: spatial flip, in/out swapped."""
    return w.flip(0, 1).transpose(2, 3)


def conv_direct_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      pads: tuple[int, int, int, int] = (0, 0, 0, 0),
                      dil: int = 1, flip: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the direct-conv kernel, in the TPU
    kernel's form: the dilated, padded input, then the sum over (ky, kx)
    of (N*OH*OW, C) @ (C, O) window products, in float32, rounded to x's
    type at the end."""
    dtype = x.dtype
    x, w = x.float(), w.float()
    if flip:
        w = _flipped(w)
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    if dil > 1:
        xd = x.new_zeros((n, (h - 1) * dil + 1, (wd - 1) * dil + 1, c))
        xd[:, ::dil, ::dil] = x
        x = xd
    pt, pb, pl, pr = pads
    x = F.pad(x, (0, 0, pl, pr, pt, pb))
    oh = (x.shape[1] - kh) // stride + 1
    ow = (x.shape[2] - kw) // stride + 1
    acc = x.new_zeros((n * oh * ow, o))
    for ky in range(kh):
        for kx in range(kw):
            win = x[:, ky:ky + stride * (oh - 1) + 1:stride,
                    kx:kx + stride * (ow - 1) + 1:stride]
            acc = acc + win.reshape(-1, c) @ w[ky, kx]
    return acc.reshape(n, oh, ow, o).to(dtype)


class ConvPlan(NamedTuple):
    """K4's launch plan: a block per bm x bn output tile (output pixels x
    output channels), grid_m x grid_n blocks, 16-byte copies when `vec`;
    `smem_bytes` is the kernel's dynamic shared memory."""
    bm: int
    bn: int
    vec: bool
    grid_m: int
    grid_n: int
    smem_bytes: int


def conv_direct_plan(n: int, oh: int, ow: int, c: int, o: int, kh: int,
                     kw: int, *, flip: bool, itemsize: int, x_ptr: int,
                     w_ptr: int) -> ConvPlan:
    """The tile plan of `csrc/conv_direct.cu` for an output (n, oh, ow, o)
    over K = kh * kw * c, elements of `itemsize` bytes (4 float32, 2
    bf16).

    bn is the smallest of 16, 32, 64, 128 (float32: up to 64, its register
    tile) that holds O, halved while the grid has fewer blocks than the
    card has SMs. vec (16-byte copies, one tap each) needs C, and without
    flip O, to be multiples of a 16-byte chunk; then x and w must be
    16-byte aligned, else ValueError (a misaligned view is refused, not
    sent down the element-wise gather)."""
    if itemsize not in (2, 4):
        raise ValueError(f"conv_direct_plan: itemsize {itemsize}")
    m = n * oh * ow
    chunk = 16 // itemsize
    slice_k = 4 * chunk                   # 64 bytes of a row per K slice
    bn = 16
    while bn < min(o, _CONV_MAX_BN[itemsize]):
        bn *= 2
    grid_m = -(-m // _CONV_BM)
    while bn > 16 and grid_m * -(-o // bn) < _SMS:
        bn //= 2
    vec = c % chunk == 0 and (flip or o % chunk == 0)
    if vec and (x_ptr % 16 or w_ptr % 16):
        raise ValueError(f"conv_direct: x (0x{x_ptr:x}) and w (0x{w_ptr:x}) "
                         "must be 16-byte aligned for the 16-byte copies "
                         "this geometry takes; pass a fresh tensor, not an "
                         "offset view")
    ld_a = slice_k + chunk
    b_elems = bn * (slice_k + chunk) if flip else slice_k * (bn + chunk)
    smem = _CONV_STAGES * (_CONV_BM * ld_a + b_elems) * itemsize
    return ConvPlan(_CONV_BM, bn, vec, grid_m, -(-o // bn), smem)


def conv_direct(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                pads: tuple[int, int, int, int] = (0, 0, 0, 0),
                dil: int = 1, flip: bool = False) -> torch.Tensor:
    """Direct conv, NHWC x (N, H, W, C) and HWIO w (KH, KW, C, O), or with
    flip the forward weights (KH, KW, O, C) of the conv whose input
    gradient this is. pads = (top, bottom, left, right) of the input
    dilated by `dil`. CUDA tensors launch `csrc/conv_direct.cu`; CPU
    tensors take `conv_direct_plain`."""
    if not x.is_cuda:
        return conv_direct_plain(x, w, stride=stride, pads=pads, dil=dil,
                                 flip=flip)
    return _conv_direct_cuda(x, w, stride=stride, pads=pads, dil=dil,
                             flip=flip)


def _conv_direct_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                      pads: tuple[int, int, int, int], dil: int,
                      flip: bool) -> torch.Tensor:
    """conv_direct's launch: shapes, the tile plan (which refuses
    misaligned operands), then the device checks and the kernel."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv_direct: want NHWC x and 4-d w, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    wc, o = (w.shape[3], w.shape[2]) if flip else (w.shape[2], w.shape[3])
    if wc != c or stride < 1 or dil < 1:
        raise ValueError(f"conv_direct: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (flip={flip}), stride {stride}, "
                         f"dil {dil}")
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, pads, dil)
    if oh < 1 or ow < 1:
        raise ValueError(f"conv_direct: empty output {oh}x{ow}")
    plan = conv_direct_plan(n, oh, ow, c, o, kh, kw, flip=flip,
                            itemsize=x.element_size(), x_ptr=x.data_ptr(),
                            w_ptr=w.data_ptr())
    dtype = _check("conv_direct", x, w)
    y = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_direct")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, o, kh, kw, oh,
        ow, stride, pads[0], pads[2], dil, int(flip), plan.bn, int(plan.vec),
        plan.grid_m, plan.grid_n, dtype, _stream(x))
    _kernels.check("conv_direct", err)
    _kernels.launches["conv_direct"] += 1
    return y


def conv_input_grad_pads(h: int, w: int, kh: int, kw: int, stride: int,
                         padding: int, oh: int,
                         ow: int) -> tuple[int, int, int, int]:
    """Padding of the stride-dilated cotangent that makes the stride-1
    transposed conv recover the (h, w) input extent (`_conv_bwd`'s
    ph, ph + eh, pw, pw + ew, pallas_ops.py:379-383)."""
    ph, pw = kh - 1 - padding, kw - 1 - padding
    eh = h - ((oh - 1) * stride + 1 + 2 * ph - kh + 1)
    ew = w - ((ow - 1) * stride + 1 + 2 * pw - kw + 1)
    return ph, ph + eh, pw, pw + ew


# ---------------------------------------------------------------------------
# K5: conv weight gradient
# ---------------------------------------------------------------------------


def conv_dw_plain(x: torch.Tensor, g: torch.Tensor, *, stride: int,
                  padding: int, kh: int, kw: int) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel, in the TPU
    kernel's form: dw[ky, kx] = window(ky, kx)^T @ g over every pixel, in
    float32, rounded to x's type at the end."""
    c = x.shape[3]
    _, oh, ow, o = g.shape
    xp = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    g2 = g.float().reshape(-1, o)
    rows = []
    for ky in range(kh):
        for kx in range(kw):
            win = xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                     kx:kx + stride * (ow - 1) + 1:stride]
            rows.append(win.reshape(-1, c).t() @ g2)
    return torch.stack(rows).reshape(kh, kw, c, o).to(x.dtype)


def pixel_tile(n: int, oh: int, ow: int) -> tuple[int, int, int]:
    """The output-pixel tile of K5 and K6: (images, rows, columns) of at
    most _TILE_PIXELS pixels. Whole images where one fits (several at a
    time), else whole rows, else a run of one row."""
    if oh * ow <= _TILE_PIXELS:
        return min(n, _TILE_PIXELS // (oh * ow)), oh, ow
    if ow <= _TILE_PIXELS:
        return 1, _TILE_PIXELS // ow, ow
    return 1, 1, _TILE_PIXELS


def halo_extent(th: int, tw: int, kh: int, kw: int,
                stride: int) -> tuple[int, int]:
    """Rows and columns of x under a th x tw output tile: the tile's
    windows with the kernel's border."""
    return stride * (th - 1) + kh, stride * (tw - 1) + kw


def _shrink(ni: int, th: int, tw: int) -> tuple[int, int, int]:
    """The next smaller tile, where a halo does not fit shared memory."""
    if ni > 1:
        return ni // 2, th, tw
    if th > 1:
        return ni, th // 2, tw
    if tw > 1:
        return ni, th, tw // 2
    raise ValueError("no tile of one pixel fits shared memory")


def _grid_of(n: int, oh: int, ow: int, ni: int, th: int, tw: int) -> int:
    return -(-n // ni) * -(-oh // th) * -(-ow // tw)


def _refuse_misaligned(name: str, **ptrs: int | None) -> None:
    """ValueError unless each operand given (None: copied element-wise)
    is 16-byte aligned."""
    for operand, ptr in ptrs.items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name}: {operand} (0x{ptr:x}) must be 16-byte "
                             "aligned for the 16-byte copies this geometry "
                             "takes; pass a fresh tensor, not an offset view")


class ConvDwPlan(NamedTuple):
    """K5's launch plan. Pixel tiles of ni images x th x tw output pixels;
    an output tile of up to _DW_MAX_TAPS taps x cs channels (of C padded
    to cp) x bn output channels; grid_m pixel chunks of tiles_per_chunk
    tiles each, by grid_n output tiles. `x_vec`, `g_vec`: 16-byte copies
    of x, of g. `one_pass`: the last block of an output tile sums the
    chunks' partials (a counter per output tile), else a second kernel
    does; `scratch` float32 partials (0 for one chunk); `smem_bytes` the
    kernel's dynamic shared memory."""
    ni: int
    th: int
    tw: int
    cs: int
    cp: int
    bn: int
    taps: int
    x_vec: bool
    g_vec: bool
    tiles_per_chunk: int
    grid_m: int
    grid_n: int
    one_pass: bool
    scratch: int
    smem_bytes: int


def _dw_smem(ni: int, th: int, tw: int, kh: int, kw: int, stride: int,
             cs: int, bn: int, itemsize: int) -> int:
    """The decode tables (two of _TILE_PIXELS ints, one int a halo pixel,
    rounded up to 16 bytes), then _DW_STAGES[itemsize] stages of (x halo
    [pixels][cs + 16 bytes], g tile [_TILE_PIXELS][bn + 16 bytes])."""
    hh, hw = halo_extent(th, tw, kh, kw, stride)
    pad = 16 // itemsize
    stage = (ni * hh * hw * (cs + pad) + _TILE_PIXELS * (bn + pad)) * itemsize
    tables = 4 * (2 * _TILE_PIXELS + -(-(ni * hh * hw) // 4) * 4)
    return tables + _DW_STAGES[itemsize] * stage


def conv_dw_plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
                 oh: int, ow: int, stride: int, *, itemsize: int, x_ptr: int,
                 g_ptr: int) -> ConvDwPlan:
    """The tile plan of `csrc/conv_dw.cu` for the weight gradient (kh, kw,
    c, o) of x (n, h, w, c) -> g (n, oh, ow, o).

    The output tile: bf16 16 channels x 64 (one m16 tile a tap, each warp
    16 of the 64); float32 16 x 64 where c >= 16 and o >= 64, else 4 x 32
    (a narrow register tile for the latency-bound shapes). Pixel chunks:
    enough for two blocks on each SM, grown while the partials pass
    _DW_MAX_PARTIAL floats. One pass where an output tile's partials are
    at most _DW_ONE_PASS_MAX floats. x_vec (16-byte copies of x) needs c
    to be a multiple of a 16-byte chunk, g_vec o; where either holds, that
    operand must be 16-byte aligned, else ValueError."""
    if itemsize not in (2, 4):
        raise ValueError(f"conv_dw_plan: itemsize {itemsize}")
    chunk = 16 // itemsize
    if itemsize == 2 or (c >= 16 and o >= 64):
        cs, bn = 16, 64
    else:
        cs, bn = 4, 32
    cp = -(-c // cs) * cs
    ni, th, tw = pixel_tile(n, oh, ow)
    while _dw_smem(ni, th, tw, kh, kw, stride, cs, bn, itemsize) > _SMEM_LIMIT:
        ni, th, tw = _shrink(ni, th, tw)
    x_vec, g_vec = c % chunk == 0, o % chunk == 0
    _refuse_misaligned("conv_dw", x=x_ptr if x_vec else None,
                       g=g_ptr if g_vec else None)
    taps = min(kh * kw, _DW_MAX_TAPS)
    grid_n = -(-(kh * kw) // taps) * (cp // cs) * -(-o // bn)
    ntiles = _grid_of(n, oh, ow, ni, th, tw)
    nout = kh * kw * c * o
    chunks = min(ntiles, max(1, -(-2 * _SMS // grid_n)),
                 max(1, _DW_MAX_PARTIAL // nout))
    tpc = -(-ntiles // chunks)
    grid_m = -(-ntiles // tpc)
    tile_out = taps * min(cs, c) * min(bn, o)
    one_pass = grid_m * tile_out <= _DW_ONE_PASS_MAX
    scratch = grid_m * nout if grid_m > 1 else 0
    return ConvDwPlan(ni, th, tw, cs, cp, bn, taps, x_vec, g_vec, tpc, grid_m,
                      grid_n, one_pass, scratch,
                      _dw_smem(ni, th, tw, kh, kw, stride, cs, bn, itemsize))


def conv_dw(x: torch.Tensor, g: torch.Tensor, *, stride: int, padding: int,
            kh: int, kw: int) -> torch.Tensor:
    """Weight gradient (KH, KW, C, O) of the conv x (N, H, W, C) ->
    g (N, OH, OW, O) with the given stride and symmetric padding. CUDA
    tensors launch `csrc/conv_dw.cu` (one or two kernels, one count);
    CPU tensors take `conv_dw_plain`."""
    if not x.is_cuda:
        return conv_dw_plain(x, g, stride=stride, padding=padding, kh=kh,
                             kw=kw)
    return _conv_dw_cuda(x, g, stride=stride, padding=padding, kh=kh, kw=kw)


def _conv_dw_cuda(x: torch.Tensor, g: torch.Tensor, *, stride: int,
                  padding: int, kh: int, kw: int) -> torch.Tensor:
    """conv_dw's launch: shapes, the tile plan (which refuses misaligned
    operands), then the device checks and the kernel."""
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"conv_dw: want NHWC x and g, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    n, h, wd, c = x.shape
    _, oh, ow, o = g.shape
    if (oh, ow) != conv_out_hw(h, wd, kh, kw, stride, (padding,) * 4, 1):
        raise ValueError(f"conv_dw: g {tuple(g.shape)} is not the output of "
                         f"x {tuple(x.shape)} under k{kh}x{kw} s{stride} "
                         f"p{padding}")
    plan = conv_dw_plan(n, h, wd, c, o, kh, kw, oh, ow, stride,
                        itemsize=x.element_size(), x_ptr=x.data_ptr(),
                        g_ptr=g.data_ptr())
    dtype = _check("conv_dw", x, g)
    part = (torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
            if plan.scratch else None)
    counters = (_counter_buffer("conv_dw", x.device, plan.grid_n)
                if plan.scratch and plan.one_pass else None)
    dw = torch.empty((kh, kw, c, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_dw")(
        x.data_ptr(), g.data_ptr(), None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), dw.data_ptr(), n,
        h, wd, c, o, kh, kw, oh, ow, stride, padding, plan.ni, plan.th,
        plan.tw, plan.cs, plan.bn, int(plan.x_vec), int(plan.g_vec),
        plan.tiles_per_chunk, plan.grid_m, int(plan.one_pass), dtype,
        _stream(x))
    _kernels.check("conv_dw", err)
    _kernels.launches["conv_dw"] += 1
    return dw


# ---------------------------------------------------------------------------
# K6: stride-1 implicit-GEMM conv
# ---------------------------------------------------------------------------


def conv_gemm_plain(x: torch.Tensor, w: torch.Tensor, *,
                    padding: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the implicit-GEMM kernel, with the patch
    matrix P built explicitly: the padded input's (ky, kx) windows
    concatenated in (ky, kx, c) order, then P @ W_flat in float32,
    rounded to x's type."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    p = torch.cat([xp[:, ky:ky + oh, kx:kx + ow] for ky in range(kh)
                   for kx in range(kw)], dim=-1).reshape(-1, kh * kw * c)
    y = p.float() @ w.reshape(kh * kw * c, o).float()
    return y.to(x.dtype).reshape(n, oh, ow, o)


class ConvGemmPlan(NamedTuple):
    """K6's launch plan: a block per output tile of ni images x th x tw
    pixels (at most _TILE_PIXELS) x bn output channels, grid_m x grid_n
    blocks. The block holds the tile's x halo in shared memory, cs
    channels (of C padded to cp) at a time, and steps through the weight
    rows kc channels of one tap at a time. `x_vec`, `w_vec`: 16-byte
    copies of x, of w; `smem_bytes` the kernel's dynamic shared memory."""
    ni: int
    th: int
    tw: int
    bn: int
    x_vec: bool
    w_vec: bool
    cp: int
    cs: int
    kc: int
    grid_m: int
    grid_n: int
    smem_bytes: int


def _gemm_smem(ni: int, th: int, tw: int, kh: int, kw: int, cs: int,
               bn: int, itemsize: int) -> int:
    """The weight ring [_GEMM_STAGES][_GEMM_STEP_ROWS][bn + 16 bytes] and
    the halo [pixels][cs + 16 bytes]."""
    hh, hw = halo_extent(th, tw, kh, kw, 1)
    pad = 16 // itemsize
    return itemsize * (_GEMM_STAGES * _GEMM_STEP_ROWS[itemsize] * (bn + pad)
                       + ni * hh * hw * (cs + pad))


def _gemm_step(cs: int, itemsize: int) -> int:
    """Channels of one k-step: in bf16 two m16n8k16 depths (32) where the
    slice holds them, else one; in float32 the deepest of 16, 8, 4 that
    divides the slice."""
    steps = (32, 16) if itemsize == 2 else (16, 8, 4)
    return next(k for k in steps if cs % k == 0)


def conv_gemm_plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
                   padding: int, *, itemsize: int, x_ptr: int,
                   w_ptr: int) -> ConvGemmPlan:
    """The tile plan of `csrc/conv_gemm.cu` for the stride-1 conv of x (n,
    h, w, c) with w (kh, kw, c, o) and symmetric padding.

    The pixel tile is `pixel_tile`'s; C is padded with zeros to a whole
    m16n8k16 depth (16) in bf16, to a 16-byte chunk (4) in float32. The
    halo slice cs is the largest divisor of the padded C (a multiple of
    the padding unit) whose shared memory stays under _GEMM_SMEM_TARGET,
    else the smallest one, while it fits 227 KB; else the tile shrinks.
    bn is the smallest of _GEMM_BNS that holds O, halved while the grid
    has fewer blocks than the card has SMs. x_vec (16-byte copies of x)
    needs C to be a multiple of a 16-byte chunk, w_vec O; where either
    holds, that operand must be 16-byte aligned, else ValueError."""
    if itemsize not in (2, 4):
        raise ValueError(f"conv_gemm_plan: itemsize {itemsize}")
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv_gemm_plan: empty output {oh}x{ow}")
    chunk = 16 // itemsize
    unit = 16 if itemsize == 2 else 4
    cp = -(-c // unit) * unit
    bns = _GEMM_BNS[itemsize]
    bn = next((b for b in bns if b >= o), bns[-1])
    ni, th, tw = pixel_tile(n, oh, ow)
    while True:
        grid_m = _grid_of(n, oh, ow, ni, th, tw)
        slices = [d for d in range(cp, 0, -unit) if cp % d == 0]
        fits = [d for d in slices
                if _gemm_smem(ni, th, tw, kh, kw, d, bns[-1], itemsize)
                <= _GEMM_SMEM_TARGET]
        cs = fits[0] if fits else slices[-1]
        if _gemm_smem(ni, th, tw, kh, kw, cs, bns[-1], itemsize) <= _SMEM_LIMIT:
            break
        ni, th, tw = _shrink(ni, th, tw)
    while bn > bns[0] and grid_m * -(-o // bn) < _SMS:
        bn //= 2
    x_vec, w_vec = c % chunk == 0, o % chunk == 0
    _refuse_misaligned("conv_gemm", x=x_ptr if x_vec else None,
                       w=w_ptr if w_vec else None)
    return ConvGemmPlan(ni, th, tw, bn, x_vec, w_vec, cp, cs,
                        _gemm_step(cs, itemsize),
                        grid_m, -(-o // bn),
                        _gemm_smem(ni, th, tw, kh, kw, cs, bn, itemsize))


def conv_gemm(x: torch.Tensor, w: torch.Tensor, *,
              padding: int = 0) -> torch.Tensor:
    """Stride-1 conv of NHWC x (N, H, W, C) with HWIO w (KH, KW, C, O) and
    symmetric `padding`. CUDA tensors launch `csrc/conv_gemm.cu`; CPU
    tensors take `conv_gemm_plain`."""
    if not x.is_cuda:
        return conv_gemm_plain(x, w, padding=padding)
    return _conv_gemm_cuda(x, w, padding=padding)


def _conv_gemm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                    padding: int) -> torch.Tensor:
    """conv_gemm's launch: shapes, the tile plan (which refuses
    misaligned operands), then the device checks and the kernel."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_gemm: want NHWC x and HWIO w, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    if padding < 0 or oh < 1 or ow < 1:
        raise ValueError(f"conv_gemm: empty output {oh}x{ow} (padding "
                         f"{padding})")
    plan = conv_gemm_plan(n, h, wd, c, o, kh, kw, padding,
                          itemsize=x.element_size(), x_ptr=x.data_ptr(),
                          w_ptr=w.data_ptr())
    dtype = _check("conv_gemm", x, w)
    y = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_gemm")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, o, kh, kw,
        padding, plan.ni, plan.th, plan.tw, plan.bn, int(plan.x_vec),
        int(plan.w_vec), plan.cs, plan.kc, plan.grid_m, plan.grid_n, dtype,
        _stream(x))
    _kernels.check("conv_gemm", err)
    _kernels.launches["conv_gemm"] += 1
    return y


# ---------------------------------------------------------------------------
# The conv layers' autograd functions
# ---------------------------------------------------------------------------


def _conv_backward(ctx, g, stride: int, padding: int):
    """`_conv_bwd` (pallas_ops.py:355-387): dx on K4 as the transposed
    conv, dw on K5, both in x's type with g cast to it first."""
    x, w = ctx.saved_tensors
    kh, kw = w.shape[:2]
    g = g.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        pads = conv_input_grad_pads(x.shape[1], x.shape[2], kh, kw, stride,
                                    padding, g.shape[1], g.shape[2])
        dx = conv_direct(g, w, stride=1, pads=pads, dil=stride, flip=True)
    if ctx.needs_input_grad[1]:
        dw = conv_dw(x, g, stride=stride, padding=padding, kh=kh, kw=kw)
    return dx, dw


class _ConvFn(torch.autograd.Function):
    """Twin of `conv2d_pallas` (pallas_ops.py:344-390)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return conv_direct(x, w, stride=stride, pads=(padding,) * 4)

    @staticmethod
    def backward(ctx, g):
        return (*_conv_backward(ctx, g, ctx.stride, ctx.padding), None, None)


def conv2d_kernel(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """Conv x (N, H, W, Cin) with w (kh, kw, Cin, Cout), forward on K4,
    input gradient on K4 (the transposed conv), weight gradient on K5."""
    return _ConvFn.apply(x, w, stride, padding)


class _ConvGemmFn(torch.autograd.Function):
    """Twin of `conv2d_pallas_gemm` (pallas_conv_gemm.py:160-173): the
    forward on K6, the backward `_conv_bwd`'s (K4 and K5)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv_gemm(x, w, padding=padding)

    @staticmethod
    def backward(ctx, g):
        return (*_conv_backward(ctx, g, 1, ctx.padding), None)


def conv2d_gemm_kernel(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                       padding: int = 0) -> torch.Tensor:
    """Conv x (N, H, W, Cin) with w (kh, kw, Cin, Cout), stride 1 only:
    forward on K6, input gradient on K4, weight gradient on K5. A stride
    other than 1 raises ValueError, on the CPU and on the card alike, as
    `conv2d_pallas_gemm` does."""
    if stride != 1:
        raise ValueError(f"conv2d_gemm_kernel is the stride-1 formulation "
                         f"(got stride {stride}); strided convs use "
                         "conv2d_kernel's direct path")
    return _ConvGemmFn.apply(x, w, padding)

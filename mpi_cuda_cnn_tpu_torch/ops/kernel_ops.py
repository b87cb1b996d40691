"""The CNN's hand-written CUDA kernels and the autograd functions over
them (counterpart of the reference's `ops/pallas_ops.py` and
`ops/pallas_conv_gemm.py`).

Four kernels, each under `csrc/` with a plain PyTorch version beside it,
each taking float32 or bfloat16 (every operand of one call in one type),
accumulating in float32 and rounding once to that type at the store:

- K3 `gemm` (`csrc/gemm.cu`): op(A) @ op(B) [+ bias], either operand
  read transposed in place. Replaces `_matmul`.
- K4 `conv_direct` (`csrc/conv_direct.cu`): a direct NHWC/HWIO conv with
  stride, per-side padding, input dilation and a weight flip as
  arguments. Replaces `_conv1` with its phase split (`_conv_forward`),
  and is also the transposed conv of the input gradient (K4').
- K5 `conv_dw` (`csrc/conv_dw.cu`): the conv weight gradient, a
  deterministic two-pass sum over pixels. Replaces `_conv1_dw`/`_conv_dw`.
- K6 `conv_gemm` (`csrc/conv_gemm.cu`): the stride-1 implicit-GEMM conv,
  its patch tile built in shared memory only. Replaces `_conv1_gemm`.

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

import torch
import torch.nn.functional as F

from . import _kernels

_GEMM_DEPTH = 32      # K slice of the GEMM kernel; kchunk is a multiple
_GEMM_TILE = 32       # output tile edge
_SPLIT_MIN_K = 128    # split K only into slices at least this deep
_SPLIT_BLOCKS = 128   # aim for about this many blocks (132 SMs)
_DW_CHUNK = 64        # pixels per block in K5's first pass
_DW_MAX_PARTIAL = 1 << 24  # floats of K5 scratch before chunks grow


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


def gemm_splits(m: int, n: int, k: int) -> tuple[int, int]:
    """(kchunk, splits) of the K split: a grid of few output tiles over
    a deep K is cut into slices of at least _SPLIT_MIN_K, so that about
    _SPLIT_BLOCKS blocks share the work; otherwise one slice."""
    tiles = -(-m // _GEMM_TILE) * -(-n // _GEMM_TILE)
    splits = max(1, min(k // _SPLIT_MIN_K, _SPLIT_BLOCKS // tiles))
    kchunk = -(-k // splits)
    kchunk = -(-kchunk // _GEMM_DEPTH) * _GEMM_DEPTH
    return kchunk, -(-k // kchunk)


def gemm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
         trans_b: bool = False,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """op(a) @ op(b) [+ bias], float32 or bfloat16: a is (M, K), or (K, M)
    with trans_a; b is (K, N), or (N, K) with trans_b; bias (N,). CUDA
    tensors launch `csrc/gemm.cu`; CPU tensors take `gemm_plain`."""
    if not a.is_cuda:
        return gemm_plain(a, b, trans_a=trans_a, trans_b=trans_b, bias=bias)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm: want 2-d operands, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    m, k = a.shape[::-1] if trans_a else a.shape
    kb, n = b.shape[::-1] if trans_b else b.shape
    if kb != k or (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"gemm: op(a) {m}x{k}, op(b) {kb}x{n}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    dtype = _check("gemm", a, b, *(() if bias is None else (bias,)))
    kchunk, splits = gemm_splits(m, n, k)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    err = _kernels.lib("gemm")(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        c.data_ptr(), None if work is None else work.data_ptr(), m, n, k,
        int(trans_a), int(trans_b), kchunk, splits, dtype, _stream(a))
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
    dtype = _check("conv_direct", x, w)
    y = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_direct")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, o, kh, kw, oh,
        ow, stride, pads[0], pads[2], dil, int(flip), dtype, _stream(x))
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


def conv_dw_chunk(pixels: int, nout: int) -> int:
    """Pixels per block of K5's first pass: _DW_CHUNK, grown where the
    partial sums (chunks x outputs) would pass _DW_MAX_PARTIAL floats."""
    chunks = max(1, min(-(-pixels // _DW_CHUNK), _DW_MAX_PARTIAL // nout))
    return -(-pixels // chunks)


def conv_dw(x: torch.Tensor, g: torch.Tensor, *, stride: int, padding: int,
            kh: int, kw: int) -> torch.Tensor:
    """Weight gradient (KH, KW, C, O) of the conv x (N, H, W, C) ->
    g (N, OH, OW, O) with the given stride and symmetric padding. CUDA
    tensors launch `csrc/conv_dw.cu` (two passes, one count); CPU tensors
    take `conv_dw_plain`."""
    if not x.is_cuda:
        return conv_dw_plain(x, g, stride=stride, padding=padding, kh=kh,
                             kw=kw)
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"conv_dw: want NHWC x and g, got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    n, h, wd, c = x.shape
    _, oh, ow, o = g.shape
    if (oh, ow) != conv_out_hw(h, wd, kh, kw, stride, (padding,) * 4, 1):
        raise ValueError(f"conv_dw: g {tuple(g.shape)} is not the output of "
                         f"x {tuple(x.shape)} under k{kh}x{kw} s{stride} "
                         f"p{padding}")
    dtype = _check("conv_dw", x, g)
    nout = kh * kw * c * o
    chunk = conv_dw_chunk(n * oh * ow, nout)
    nchunks = -(-(n * oh * ow) // chunk)
    part = torch.empty((nchunks, nout), dtype=torch.float32, device=x.device)
    dw = torch.empty((kh, kw, c, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_dw")(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h, wd,
        c, o, kh, kw, oh, ow, stride, padding, chunk, dtype, _stream(x))
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


def conv_gemm(x: torch.Tensor, w: torch.Tensor, *,
              padding: int = 0) -> torch.Tensor:
    """Stride-1 conv of NHWC x (N, H, W, C) with HWIO w (KH, KW, C, O) and
    symmetric `padding`. CUDA tensors launch `csrc/conv_gemm.cu`; CPU
    tensors take `conv_gemm_plain`."""
    if not x.is_cuda:
        return conv_gemm_plain(x, w, padding=padding)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_gemm: want NHWC x and HWIO w, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    if padding < 0 or oh < 1 or ow < 1:
        raise ValueError(f"conv_gemm: empty output {oh}x{ow} (padding "
                         f"{padding})")
    dtype = _check("conv_gemm", x, w)
    y = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    err = _kernels.lib("conv_gemm")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, o, kh, kw,
        padding, dtype, _stream(x))
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

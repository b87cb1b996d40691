"""Flash attention: the LM's fused attention, forward and backward, on
three hand-written CUDA kernels (counterpart of the reference's
`ops/pallas_attention.py`).

- K7 `flash_forward` (`csrc/flash_fwd.cu`): o and the per-row logsumexp
  with an online softmax; on `mma.sync` in both types: bf16 operands,
  float32 ones as 3xTF32 (each split into two tf32 values, three
  tensor-core products; float32 accuracy). Replaces
  `_flash_kernel`/`_flash_forward`.
- K8 `flash_bwd_dq` (`csrc/flash_bwd_dq.cu`); on `mma.sync` in both
  types: bf16 operands, float32 ones as 3xTF32 (each split into two tf32
  values, three tensor-core products; float32 accuracy). Replaces
  `_bwd_dq_kernel`.
- K9 `flash_bwd_dkv` (`csrc/flash_bwd_dkv.cu`); on `mma.sync` as K8, a
  block per query head and, under GQA, float32 partials summed over the
  group in a fixed order by a second kernel of the same launch. Replaces
  `_bwd_dkv_kernel` and the group sum after it.

`flash_fwd_plan` is K7's launch geometry and `flash_bwd_plan` K8's and
K9's (grid, threads, shared memory, K9's GQA scratch), computed on the
host and handed to the C launch functions, which refuse any other.

`flash_backward` is the reference's `_flash_backward`: dvec, then K8
and K9.

`flash_attention` is the `torch.autograd.Function` over them, the twin
of the reference's `custom_vjp`: one K7 launch per forward, one K8 and
one K9 launch per backward.

The reference's contracts are kept: q (B, S, H, D), k/v (B, S, Hkv, D)
with H % Hkv == 0; S a multiple of 128 (ValueError otherwise, on any
device); scale 1/sqrt(D); dvec = rowsum(dO * O) in float32, computed
outside the kernels. The tensor-core kernels are built at the head dims
`HEAD_DIMS` (up to `MAX_HEAD_DIM`, 256); above it each kernel has a wide
form (`flash_common.cuh`: the output columns split across blocks in
chunks of `WIDE_COLS`, each block computing the logits over the whole D
again, D streamed through shared memory in chunks), which takes any
multiple of `WIDE_COLS`. On the card any other D goes through
`pad_route`: q, k, v and dO are zero-padded along D to the next
instance or multiple (`kernel_head_dim`), which leaves q k^T, the
softmax and dO v^T as they are and the extra output and gradient columns
zero, the kernels take the real D's scale, and the outputs are sliced
back. So every D the reference takes runs on the kernels. Dtype policy:
float32 inputs compute in float32; bf16 inputs stay bf16 operands with
float32 logits, softmax and accumulators, p rounded to bf16 before the
PV product and ds / p^T before the backward products; any other type
computes as float32. The output
comes back in q's type and each gradient in its input's type, or, with
the reference's `out_f32` / `grads_f32`, in float32 unrounded (the
ring-flash fold and backward of `parallel/sp.py` merge and accumulate
their hops in float32).

Every function takes its plain PyTorch version (full-matrix float32
math, `*_plain`) for CPU tensors, and only for them. A CUDA tensor
launches the kernel or raises; there is no fallback. While a step is
counted (`obs/cost.py`), each kernel call adds its nominal work at the
real D (`attention_flops`: the full S x S square, causal or not) to the
open counter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs import cost as _cost
from . import _kernels
from .attention import NEG_INF

# head dims the kernels are built for (`with_head_dim` in
# csrc/flash_common.cuh); 80, 96 and 256 are the published head dims of
# Phi-2, Phi-3-mini and Gemma-7B
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]    # the largest tensor-core instance
WIDE_COLS = 64              # above it: the wide kernels' column chunk
_WIDE_THREADS = 256         # the wide kernels: 16 x 16 threads
_WIDE_SMEM = 2 * 64 * (64 + 4) * 4   # two (64, 64) float32 tiles, rows + 16 B
_TILE = 64                  # rows of a query tile, keys of a key tile
_MMA_THREADS = 128          # K7, K8 and K9: 4 warps x 16 rows
_ROW_PAD = 16               # bytes of padding after each staged tile row
_SUM_THREADS, _SUM_VEC = 256, 4   # K9's group sum: 4 floats a thread


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q (B, S, H, D) and k/v "
                         f"(B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if s % 128:
        raise ValueError(f"seq len {s} must be a multiple of 128")


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run `d` at: the smallest of `HEAD_DIMS`
    that is >= d, and above `MAX_HEAD_DIM` the next multiple of
    `WIDE_COLS` (the wide kernels). ValueError below 1."""
    if d < 1:
        raise ValueError(f"flash attention kernels take head dims >= 1; "
                         f"got {d}")
    if d > MAX_HEAD_DIM:
        return -(-d // WIDE_COLS) * WIDE_COLS
    return next(k for k in HEAD_DIMS if k >= d)


def is_wide(d: int) -> bool:
    """Whether head dim `d` (a kernel head dim) runs on the wide
    kernels."""
    return d > MAX_HEAD_DIM


def pad_route(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *rest, **kwargs):
    """fn(q, k, v, *rest, scale=1/sqrt(D), **kwargs) at the kernels' head
    dim: q, k, v and every 4-d tensor of `rest` (dO) zero-padded along D
    to `kernel_head_dim(D)`, and every 4-d output (o, dq, dk, dv) sliced
    back to D; lse and dvec, (B * H, S), pass as they are. The zero
    columns of q and k leave q k^T unchanged and those of v and dO leave
    dO v^T unchanged, so the padded columns of every output are zero.
    The card's wrappers take this route to their launches; the CPU tests
    hold it to the plain versions."""
    d = q.shape[-1]
    dk = kernel_head_dim(d)

    def pad(t):
        if not isinstance(t, torch.Tensor) or t.dim() != 4 or dk == d:
            return t
        return torch.nn.functional.pad(t, (0, dk - d))

    def cut(t):
        return t[..., :d].contiguous() if t.dim() == 4 and dk != d else t

    out = fn(pad(q), pad(k), pad(v), *(pad(t) for t in rest),
             scale=1.0 / d ** 0.5, **kwargs)
    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """bf16 stays bf16; everything else computes in float32 (the
    reference's `kdt`)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _scale(d: int, scale: float | None) -> float:
    return 1.0 / d ** 0.5 if scale is None else scale


def _logits(qf: torch.Tensor, kf: torch.Tensor, causal: bool,
            scale: float | None = None):
    """Logits (B, Hkv, G, S, S) of the grouped heads in float32, scaled by
    `scale` (None: 1/sqrt(D)), causal entries set to NEG_INF; also the
    mask (None when not causal)."""
    b, s, h, d = qf.shape
    hkv = kf.shape[2]
    qg = qf.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * _scale(d, scale)
    if not causal:
        return logits, None
    pos = torch.arange(s, device=qf.device)
    mask = pos[None, :] <= pos[:, None]
    return torch.where(mask, logits, NEG_INF), mask


# products of S x S x D a kernel computes: K7 q k^T and p v; K8 q k^T,
# dO v^T and ds k; K9 those two and ds^T q, p^T dO
_SQUARE_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def attention_flops(kernel: str, b: int, s: int, h: int, d: int) -> int:
    """The nominal work of K7 ("fwd"), K8 ("dq") or K9 ("dkv") for q
    (b, s, h, d) (`obs/cost.py`): 2 b h s^2 d a product over the full
    square, as FlopCounterMode counts the plain versions."""
    return _SQUARE_PRODUCTS[kernel] * 2 * b * h * s * s * d


# ---------------------------------------------------------------------------
# K7: forward
# ---------------------------------------------------------------------------


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, out_f32: bool = False,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: full-matrix float32
    math on logits scaled by `scale` (None: 1/sqrt(D)), p = exp(s -
    rowmax) rounded to the compute type before the PV product, l summed
    unrounded; lse = rowmax + log(l), (B * H, S). o in q's type, or
    float32 with `out_f32`."""
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qf, kf, vf = (t.to(kdt).float() for t in (q, k, v))
    logits, mask = _logits(qf, kf, causal, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(kdt).float(), vf) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(l)).reshape(b * h, s)
    return (o if out_f32 else o.to(q.dtype)), lse


def _check_plan(name: str, d: int, dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16) or \
            kernel_head_dim(d) != d:
        raise ValueError(f"{name}: {dtype} at head dim {d} (instances "
                         f"{HEAD_DIMS}, or above {MAX_HEAD_DIM} a multiple "
                         f"of {WIDE_COLS})")


def stream_rows(kernel: str, dtype: torch.dtype, d: int) -> int:
    """Rows of the tiles a block streams (flash_common.cuh): the keys of a
    K7 ("fwd") or K8 ("dq") k/v tile, the queries of a K9 ("dkv") q/dO
    tile. 64, but beyond d 128 32 keys in float32 K7 and in K8, and 16
    queries in float32 K9."""
    if d <= 128:
        return _TILE
    if kernel == "dq" or (kernel == "fwd" and dtype == torch.float32):
        return 32
    if kernel == "dkv" and dtype == torch.float32:
        return 16
    return _TILE


def dkv_split(d: int) -> int:
    """K9's blocks per (batch, query head, key tile): 2 beyond d 128, each
    keeping dk and dv for half of the columns (`kDkvSplit`), else 1."""
    return 2 if d > 128 else 1


class FlashFwdPlan(NamedTuple):
    """K7's launch: a (grid_x, grid_y) grid of `threads`-thread blocks with
    `smem_bytes` of dynamic shared memory; block (x, y) owns query tile
    grid_y - 1 - y of (batch, query head) x (wide: query tile
    S / 64 - 1 - y // (d / 64), output columns 64 (y % (d / 64)) ..)."""
    grid_x: int
    grid_y: int
    threads: int
    smem_bytes: int


def flash_fwd_plan(b: int, s: int, h: int, hkv: int, d: int,
                   dtype: torch.dtype) -> FlashFwdPlan:
    """The launch plan of K7 for q (b, s, h, d) and k/v (b, s, hkv, d) in
    the compute type `dtype` (float32 or bf16) at a head dim `d` of
    `HEAD_DIMS`, as `csrc/flash_fwd.cu` checks it.

    Shared memory: rows of d elements of the input type, each padded by
    16 bytes. bf16: q and two stages of k and v, five 64-row tiles.
    float32 (3xTF32): k and v in two stages, four tiles (q staged in the
    second and split into registers); at d 80-128 two more for q split in
    place into hi and lo; beyond d 128 two stages of 32-key k and v tiles
    and q's float32 tile (`kStreamRowsF32Fwd`, 192 rows). Above d 256 the
    wide kernel: a block a (query tile, 64 output columns), 256 threads,
    two (64, 64) float32 tiles."""
    _check_plan("flash_fwd_plan", d, dtype)
    if is_wide(d):
        return FlashFwdPlan(b * h, s // _TILE * (d // WIDE_COLS),
                            _WIDE_THREADS, _WIDE_SMEM)
    elem = torch.finfo(dtype).bits // 8
    if dtype == torch.bfloat16:
        rows = 5 * _TILE
    else:
        rows = (4 * _TILE if d <= 64 else 6 * _TILE if d <= 128
                else 4 * stream_rows("fwd", dtype, d) + _TILE)
    return FlashFwdPlan(b * h, s // _TILE, _MMA_THREADS,
                        rows * (elem * d + _ROW_PAD))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, out_f32: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B, S, H, D) in q's type, or float32 unrounded with `out_f32`;
    lse (B * H, S) float32). CUDA tensors launch `csrc/flash_fwd.cu`
    through `pad_route`; CPU tensors take `flash_forward_plain`."""
    _check_shapes(q, k, v)
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal, out_f32)
    o, lse = pad_route(_flash_forward_launch, q, k, v, causal,
                       out_f32=out_f32)
    if _cost.OPEN is not None:
        _cost.OPEN.kernel(attention_flops("fwd", *q.shape), q, k, v, o, lse)
    return o, lse


def _flash_forward_launch(q, k, v, causal: bool, out_f32: bool,
                          scale: float):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc = _for_kernel("flash_fwd", kdt, q, k, v)
    plan = flash_fwd_plan(b, s, h, hkv, d, kdt)
    o = torch.empty((b, s, h, d), dtype=torch.float32 if out_f32 else kdt,
                    device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    err = _kernels.lib("flash_fwd")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, hkv, d, int(causal), scale,
        _kernels.DTYPE_CODES[kdt], int(out_f32), plan.grid_x, plan.grid_y,
        plan.threads, plan.smem_bytes, _stream(q))
    _kernels.check("flash_fwd", err)
    _kernels.launches["flash_fwd"] += 1
    return (o if out_f32 else o.to(q.dtype)), lse


# ---------------------------------------------------------------------------
# K8 and K9: backward
# ---------------------------------------------------------------------------


def row_dvec(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dvec = rowsum(dO * O) in float32 (both in the compute type first),
    laid out (B * H, S) as lse."""
    b, s, h, _ = o.shape
    kdt = _compute_dtype(o.dtype)
    dvec = (g.to(kdt).float() * o.to(kdt).float()).sum(dim=-1)
    return dvec.permute(0, 2, 1).reshape(b * h, s).contiguous()


def _bwd_plain_parts(q, k, v, g, lse, dvec, causal: bool,
                     scale: float | None = None):
    """The reference's backward algebra (pallas_attention.py:303-315,
    344-357) over full matrices in float32: p = exp(s - lse),
    ds = p * (dO v^T - dvec) * scale (None: 1/sqrt(D)), each rounded to
    the compute type before its product. Returns (ds, p, q, k, dO) with
    the heads grouped as (B, Hkv, G, ...)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    kdt = _compute_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(kdt).float() for t in (q, k, v, g))
    logits, _ = _logits(qf, kf, causal, scale)
    grp = (b, hkv, h // hkv, s, 1)
    p = torch.exp(logits - lse.reshape(grp))
    gg = gf.reshape(b, s, hkv, h // hkv, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gg, vf)
    ds = p * (dp - dvec.reshape(grp)) * _scale(d, scale)
    return (ds.to(kdt).float(), p.to(kdt).float(),
            qf.reshape(b, s, hkv, h // hkv, d), kf, gg)


def flash_bwd_dq_plain(q, k, v, g, lse, dvec, causal: bool,
                       grads_f32: bool = False,
                       scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds k, in q's type (in
    float32 with `grads_f32`); `scale` as `_bwd_plain_parts`."""
    ds, _, _, kf, _ = _bwd_plain_parts(q, k, v, g, lse, dvec, causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape)
    return dq if grads_f32 else dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, dvec, causal: bool,
                        grads_f32: bool = False,
                        scale: float | None = None):
    """Plain PyTorch version of the dk/dv kernel: dk = ds^T q and
    dv = p^T dO, summed over each kv head's query group, in k's and v's
    types (in float32 with `grads_f32`); `scale` as `_bwd_plain_parts`."""
    ds, p, qg, _, gg = _bwd_plain_parts(q, k, v, g, lse, dvec, causal, scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gg)
    if grads_f32:
        return dk, dv
    return dk.to(k.dtype), dv.to(v.dtype)


class FlashBwdPlan(NamedTuple):
    """K8's or K9's launch: a (grid_x, grid_y) grid of `threads`-thread
    blocks with `smem_bytes` of dynamic shared memory. Block (x, y) owns
    one 64-row tile of one (batch, query head) x: K8's query rows, K9's
    keys. K9 under GQA writes float32 partials to a `scratch` of shape
    (2, G, B, S, Hkv, D) that `sum_blocks` blocks of `_SUM_THREADS` sum
    over G; otherwise `scratch` is None and `sum_blocks` 0."""
    grid_x: int
    grid_y: int
    threads: int
    smem_bytes: int
    scratch: tuple[int, ...] | None
    sum_blocks: int


def flash_bwd_plan(kernel: str, b: int, s: int, h: int, hkv: int, d: int,
                   dtype: torch.dtype) -> FlashBwdPlan:
    """The launch plan of K8 (`kernel` "dq") or K9 ("dkv") for q (b, s, h,
    d) and k/v (b, s, hkv, d) in the compute type `dtype` (float32 or
    bf16) at a head dim `d` of `HEAD_DIMS`, as `csrc/flash_bwd_dq.cu` and
    `csrc/flash_bwd_dkv.cu` check it.

    Shared memory: rows of d elements of the input type, each padded by
    16 bytes. K8: the q and dO tiles (64 rows) and two stages of k and v
    tiles of `stream_rows` keys, one stage in float32 (so three blocks fit
    on an SM at d 64). K9: the k and v tiles (64 rows), two stages of q and
    dO tiles of `stream_rows` queries and of as many float32 lse and dvec
    values. K9's grid has `dkv_split(d)` blocks a key tile. Above d 256
    the wide kernels: a block a (tile, 64 output columns), 256 threads,
    two (64, 64) float32 tiles; K9's blocks are (batch, kv head) x key
    tiles and sum the query group themselves (no scratch)."""
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"flash_bwd_plan: {kernel!r}")
    _check_plan("flash_bwd_plan", d, dtype)
    if is_wide(d):
        return FlashBwdPlan(b * (h if kernel == "dq" else hkv),
                            s // _TILE * (d // WIDE_COLS), _WIDE_THREADS,
                            _WIDE_SMEM, None, 0)
    group = h // hkv
    elem = torch.finfo(dtype).bits // 8
    n = stream_rows(kernel, dtype, d)
    if kernel == "dq":
        stages = 1 if dtype == torch.float32 else 2
        smem = (2 * _TILE + 2 * stages * n) * (elem * d + _ROW_PAD)
        return FlashBwdPlan(b * h, s // _TILE, _MMA_THREADS, smem, None, 0)
    smem = (2 * _TILE + 4 * n) * (elem * d + _ROW_PAD) + 4 * 4 * n
    scratch, sum_blocks = None, 0
    if group > 1:
        scratch = (2, group, b, s, hkv, d)
        sum_blocks = -(-2 * b * s * hkv * d // (_SUM_VEC * _SUM_THREADS))
    return FlashBwdPlan(b * h, s // _TILE * dkv_split(d), _MMA_THREADS, smem,
                        scratch, sum_blocks)


def _check_bwd(name: str, q, g, lse, dvec) -> None:
    b, s, h, _ = q.shape
    if g.shape != q.shape or lse.shape != (b * h, s) or dvec.shape != lse.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)}, lse {tuple(lse.shape)}, "
                         f"dvec {tuple(dvec.shape)} for q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise TypeError(f"{name} wants float32 lse and dvec")


def flash_bwd_dq(q, k, v, g, lse, dvec, causal: bool,
                 grads_f32: bool = False) -> torch.Tensor:
    """dq from q, k, v, the output cotangent g, the forward's lse and
    dvec = `row_dvec(o, g)`, in q's type (float32 unrounded with
    `grads_f32`). CUDA tensors launch `csrc/flash_bwd_dq.cu` through
    `pad_route`; CPU tensors take `flash_bwd_dq_plain`."""
    _check_shapes(q, k, v)
    _check_bwd("flash_bwd_dq", q, g, lse, dvec)
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, g, lse, dvec, causal, grads_f32)
    dq = pad_route(_flash_bwd_dq_launch, q, k, v, g, lse, dvec, causal,
                   grads_f32=grads_f32)
    if _cost.OPEN is not None:
        _cost.OPEN.kernel(attention_flops("dq", *q.shape), q, k, v, g, lse,
                          dvec, dq)
    return dq


def _flash_bwd_dq_launch(q, k, v, g, lse, dvec, causal: bool,
                         grads_f32: bool, scale: float) -> torch.Tensor:
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc, gc = _for_kernel("flash_bwd_dq", kdt, q, k, v, g)
    lse, dvec = _for_kernel("flash_bwd_dq", torch.float32, lse, dvec, d=d,
                            device=q.device)
    hkv = k.shape[2]
    plan = flash_bwd_plan("dq", b, s, h, hkv, d, kdt)
    dq = torch.empty((b, s, h, d), dtype=torch.float32 if grads_f32 else kdt,
                     device=q.device)
    err = _kernels.lib("flash_bwd_dq")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, s, h, hkv, d,
        int(causal), scale, _kernels.DTYPE_CODES[kdt], int(grads_f32),
        plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes, _stream(q))
    _kernels.check("flash_bwd_dq", err)
    _kernels.launches["flash_bwd_dq"] += 1
    return dq if grads_f32 else dq.to(q.dtype)


def flash_bwd_dkv(q, k, v, g, lse, dvec, causal: bool,
                  grads_f32: bool = False):
    """(dk, dv), each kv head's query group summed, in k's and v's types
    (float32 unrounded with `grads_f32`). CUDA tensors launch
    `csrc/flash_bwd_dkv.cu` through `pad_route` (under GQA: the main
    kernel and the group sum, one call and one count); CPU tensors take
    `flash_bwd_dkv_plain`."""
    _check_shapes(q, k, v)
    _check_bwd("flash_bwd_dkv", q, g, lse, dvec)
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, g, lse, dvec, causal, grads_f32)
    dk, dv = pad_route(_flash_bwd_dkv_launch, q, k, v, g, lse, dvec, causal,
                       grads_f32=grads_f32)
    if _cost.OPEN is not None:
        _cost.OPEN.kernel(attention_flops("dkv", *q.shape), q, k, v, g, lse,
                          dvec, dk, dv)
    return dk, dv


def _flash_bwd_dkv_launch(q, k, v, g, lse, dvec, causal: bool,
                          grads_f32: bool, scale: float):
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc, gc = _for_kernel("flash_bwd_dkv", kdt, q, k, v, g)
    lse, dvec = _for_kernel("flash_bwd_dkv", torch.float32, lse, dvec, d=d,
                            device=q.device)
    hkv = k.shape[2]
    plan = flash_bwd_plan("dkv", b, s, h, hkv, d, kdt)
    dk = torch.empty(kc.shape, dtype=torch.float32 if grads_f32 else kdt,
                     device=q.device)
    dv = torch.empty_like(dk)
    part = (None if plan.scratch is None else
            torch.empty(plan.scratch, dtype=torch.float32, device=q.device))
    err = _kernels.lib("flash_bwd_dkv")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, s, h, hkv, d,
        int(causal), scale, _kernels.DTYPE_CODES[kdt], int(grads_f32),
        plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes,
        plan.sum_blocks, _stream(q))
    _kernels.check("flash_bwd_dkv", err)
    _kernels.launches["flash_bwd_dkv"] += 1
    if grads_f32:
        return dk, dv
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward(q, k, v, o, lse, g, causal: bool, grads_f32: bool = False):
    """(dq, dk, dv) of flash attention from the forward's o and lse and
    the output cotangent g: dvec in float32, then the dq kernel (K8) and
    the dk/dv kernel (K9), or their plain versions for CPU tensors; in
    the inputs' types, or float32 unrounded with `grads_f32`."""
    if o.shape != q.shape:
        raise ValueError(f"flash_backward: o {tuple(o.shape)} for q "
                         f"{tuple(q.shape)}")
    dvec = row_dvec(o, g)
    dq = flash_bwd_dq(q, k, v, g, lse, dvec, causal, grads_f32)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, dvec, causal, grads_f32)
    return dq, dk, dv


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _for_kernel(name: str, kdt: torch.dtype, *tensors: torch.Tensor,
                d: int | None = None, device: torch.device | None = None):
    """The tensors as the kernels take them: on one CUDA device (q's), of
    the compute type, contiguous and 16-byte aligned (the `cp.async`
    copies of K7, K8 and K9 in either type; an offset view is copied); a
    head dim the kernels are built for (`pad_route` padded to it)."""
    dev = device or tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    d = d or tensors[0].shape[-1]
    if kernel_head_dim(d) != d:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS} nor a "
                         f"multiple of {WIDE_COLS} above {MAX_HEAD_DIM}")
    out = tuple(t.to(kdt).contiguous() for t in tensors)
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in out)


class _FlashFn(torch.autograd.Function):
    """Twin of the reference's `flash_attention` custom_vjp
    (pallas_attention.py:500-521)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, g, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused scaled-dot-product attention, forward on K7, backward on K8
    and K9. q (B, S, H, D); k/v (B, S, Hkv, D), H % Hkv == 0, any D; S a
    multiple of 128."""
    return _FlashFn.apply(q, k, v, causal)

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
outside the kernels. Dtype policy: float32 inputs compute in float32;
bf16 inputs stay bf16 operands with float32 logits, softmax and
accumulators, p rounded to bf16 before the PV product and ds / p^T before
the backward products; any other type computes as float32. The output
comes back in q's type and each gradient in its input's type.

Every function takes its plain PyTorch version (full-matrix float32
math, `*_plain`) for CPU tensors, and only for them. A CUDA tensor
launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels
from .attention import NEG_INF

HEAD_DIMS = (32, 64, 128)   # head dims the kernels are built for
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


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """bf16 stays bf16; everything else computes in float32 (the
    reference's `kdt`)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _logits(qf: torch.Tensor, kf: torch.Tensor, causal: bool):
    """Scaled float32 logits (B, Hkv, G, S, S) of the grouped heads, causal
    entries set to NEG_INF; also the mask (None when not causal)."""
    b, s, h, d = qf.shape
    hkv = kf.shape[2]
    qg = qf.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / d ** 0.5)
    if not causal:
        return logits, None
    pos = torch.arange(s, device=qf.device)
    mask = pos[None, :] <= pos[:, None]
    return torch.where(mask, logits, NEG_INF), mask


# ---------------------------------------------------------------------------
# K7: forward
# ---------------------------------------------------------------------------


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: full-matrix float32
    math, p = exp(s - rowmax) rounded to the compute type before the PV
    product, l summed unrounded; lse = rowmax + log(l), (B * H, S)."""
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qf, kf, vf = (t.to(kdt).float() for t in (q, k, v))
    logits, mask = _logits(qf, kf, causal)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(kdt).float(), vf) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(l)).reshape(b * h, s)
    return o.to(q.dtype), lse


class FlashFwdPlan(NamedTuple):
    """K7's launch: a (grid_x, grid_y) grid of `threads`-thread blocks with
    `smem_bytes` of dynamic shared memory; block (x, y) owns query tile
    grid_y - 1 - y of (batch, query head) x."""
    grid_x: int
    grid_y: int
    threads: int
    smem_bytes: int


def flash_fwd_plan(b: int, s: int, h: int, hkv: int, d: int,
                   dtype: torch.dtype) -> FlashFwdPlan:
    """The launch plan of K7 for q (b, s, h, d) and k/v (b, s, hkv, d) in
    the compute type `dtype` (float32 or bf16), as `csrc/flash_fwd.cu`
    checks it.

    Shared memory: (64, d) tiles of the input type with each row padded by
    16 bytes. bf16: q and two stages of k and v, five tiles. float32
    (3xTF32): k and v in two stages, four tiles (q staged in the second
    and split into registers), and at d 128 two more for q split in place
    into hi and lo."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_fwd_plan: {dtype}")
    elem = torch.finfo(dtype).bits // 8
    tiles = 5 if dtype == torch.bfloat16 else (4 if d <= 64 else 6)
    return FlashFwdPlan(b * h, s // _TILE, _MMA_THREADS,
                        tiles * _TILE * (elem * d + _ROW_PAD))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B, S, H, D) in q's type, lse (B * H, S) float32). CUDA tensors
    launch `csrc/flash_fwd.cu`; CPU tensors take `flash_forward_plain`."""
    _check_shapes(q, k, v)
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc = _for_kernel("flash_fwd", kdt, q, k, v)
    plan = flash_fwd_plan(b, s, h, hkv, d, kdt)
    o = torch.empty((b, s, h, d), dtype=kdt, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    err = _kernels.lib("flash_fwd")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, hkv, d, int(causal), _kernels.DTYPE_CODES[kdt],
        plan.grid_x, plan.grid_y, plan.threads, plan.smem_bytes, _stream(q))
    _kernels.check("flash_fwd", err)
    _kernels.launches["flash_fwd"] += 1
    return o.to(q.dtype), lse


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


def _bwd_plain_parts(q, k, v, g, lse, dvec, causal: bool):
    """The reference's backward algebra (pallas_attention.py:303-315,
    344-357) over full matrices in float32: p = exp(s - lse),
    ds = p * (dO v^T - dvec) * scale, each rounded to the compute type
    before its product. Returns (ds, p, q, k, dO) with the heads grouped
    as (B, Hkv, G, ...)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    kdt = _compute_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(kdt).float() for t in (q, k, v, g))
    logits, _ = _logits(qf, kf, causal)
    grp = (b, hkv, h // hkv, s, 1)
    p = torch.exp(logits - lse.reshape(grp))
    gg = gf.reshape(b, s, hkv, h // hkv, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gg, vf)
    ds = p * (dp - dvec.reshape(grp)) * (1.0 / d ** 0.5)
    return (ds.to(kdt).float(), p.to(kdt).float(),
            qf.reshape(b, s, hkv, h // hkv, d), kf, gg)


def flash_bwd_dq_plain(q, k, v, g, lse, dvec, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds k, in q's type."""
    ds, _, _, kf, _ = _bwd_plain_parts(q, k, v, g, lse, dvec, causal)
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, dvec, causal: bool):
    """Plain PyTorch version of the dk/dv kernel: dk = ds^T q and
    dv = p^T dO, summed over each kv head's query group, in k's and v's
    types."""
    ds, p, qg, _, gg = _bwd_plain_parts(q, k, v, g, lse, dvec, causal)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gg)
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
    bf16), as `csrc/flash_bwd_dq.cu` and `csrc/flash_bwd_dkv.cu` check it.

    Shared memory: (64, d) tiles of the input type with each row padded
    by 16 bytes, six of them (K8: q, dO and two stages of k and v; K9: k,
    v and two stages of q and dO) but four for K8 in float32 (k and v in
    one stage, so three blocks fit on an SM), K9 also two stages of 64
    float32 lse and 64 dvec values."""
    if kernel not in ("dq", "dkv") or dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"flash_bwd_plan: {kernel!r}, {dtype}")
    group = h // hkv
    elem = torch.finfo(dtype).bits // 8
    tiles = 4 if kernel == "dq" and dtype == torch.float32 else 6
    smem = (tiles * _TILE * (elem * d + _ROW_PAD)
            + (4 * 4 * _TILE if kernel == "dkv" else 0))
    scratch, sum_blocks = None, 0
    if kernel == "dkv" and group > 1:
        scratch = (2, group, b, s, hkv, d)
        sum_blocks = -(-2 * b * s * hkv * d // (_SUM_VEC * _SUM_THREADS))
    return FlashBwdPlan(b * h, s // _TILE, _MMA_THREADS, smem, scratch,
                        sum_blocks)


def _check_bwd(name: str, q, g, lse, dvec) -> None:
    b, s, h, _ = q.shape
    if g.shape != q.shape or lse.shape != (b * h, s) or dvec.shape != lse.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)}, lse {tuple(lse.shape)}, "
                         f"dvec {tuple(dvec.shape)} for q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise TypeError(f"{name} wants float32 lse and dvec")


def flash_bwd_dq(q, k, v, g, lse, dvec, causal: bool) -> torch.Tensor:
    """dq from q, k, v, the output cotangent g, the forward's lse and
    dvec = `row_dvec(o, g)`. CUDA tensors launch `csrc/flash_bwd_dq.cu`;
    CPU tensors take `flash_bwd_dq_plain`."""
    _check_shapes(q, k, v)
    _check_bwd("flash_bwd_dq", q, g, lse, dvec)
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, g, lse, dvec, causal)
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc, gc = _for_kernel("flash_bwd_dq", kdt, q, k, v, g)
    lse, dvec = _for_kernel("flash_bwd_dq", torch.float32, lse, dvec, d=d,
                            device=q.device)
    hkv = k.shape[2]
    plan = flash_bwd_plan("dq", b, s, h, hkv, d, kdt)
    dq = torch.empty((b, s, h, d), dtype=kdt, device=q.device)
    err = _kernels.lib("flash_bwd_dq")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, s, h, hkv, d,
        int(causal), _kernels.DTYPE_CODES[kdt], plan.grid_x, plan.grid_y,
        plan.threads, plan.smem_bytes, _stream(q))
    _kernels.check("flash_bwd_dq", err)
    _kernels.launches["flash_bwd_dq"] += 1
    return dq.to(q.dtype)


def flash_bwd_dkv(q, k, v, g, lse, dvec, causal: bool):
    """(dk, dv), each kv head's query group summed. CUDA tensors launch
    `csrc/flash_bwd_dkv.cu` (under GQA: the main kernel and the group sum,
    one call and one count); CPU tensors take
    `flash_bwd_dkv_plain`."""
    _check_shapes(q, k, v)
    _check_bwd("flash_bwd_dkv", q, g, lse, dvec)
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, g, lse, dvec, causal)
    b, s, h, d = q.shape
    kdt = _compute_dtype(q.dtype)
    qc, kc, vc, gc = _for_kernel("flash_bwd_dkv", kdt, q, k, v, g)
    lse, dvec = _for_kernel("flash_bwd_dkv", torch.float32, lse, dvec, d=d,
                            device=q.device)
    hkv = k.shape[2]
    plan = flash_bwd_plan("dkv", b, s, h, hkv, d, kdt)
    dk = torch.empty(kc.shape, dtype=kdt, device=q.device)
    dv = torch.empty_like(dk)
    part = (None if plan.scratch is None else
            torch.empty(plan.scratch, dtype=torch.float32, device=q.device))
    err = _kernels.lib("flash_bwd_dkv")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, s, h, hkv, d,
        int(causal), _kernels.DTYPE_CODES[kdt], plan.grid_x, plan.grid_y,
        plan.threads, plan.smem_bytes, plan.sum_blocks, _stream(q))
    _kernels.check("flash_bwd_dkv", err)
    _kernels.launches["flash_bwd_dkv"] += 1
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward(q, k, v, o, lse, g, causal: bool):
    """(dq, dk, dv) of flash attention from the forward's o and lse and
    the output cotangent g: dvec in float32, then the dq kernel (K8) and
    the dk/dv kernel (K9), or their plain versions for CPU tensors."""
    if o.shape != q.shape:
        raise ValueError(f"flash_backward: o {tuple(o.shape)} for q "
                         f"{tuple(q.shape)}")
    dvec = row_dvec(o, g)
    dq = flash_bwd_dq(q, k, v, g, lse, dvec, causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, dvec, causal)
    return dq, dk, dv


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _for_kernel(name: str, kdt: torch.dtype, *tensors: torch.Tensor,
                d: int | None = None, device: torch.device | None = None):
    """The tensors as the kernels take them: on one CUDA device (q's), of
    the compute type, contiguous and 16-byte aligned (the `cp.async`
    copies of K7, K8 and K9 in either type; an offset view is copied); a
    head dim the kernels are built for."""
    dev = device or tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    d = d or tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
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
    and K9. q (B, S, H, D); k/v (B, S, Hkv, D), H % Hkv == 0; S a multiple
    of 128."""
    return _FlashFn.apply(q, k, v, causal)

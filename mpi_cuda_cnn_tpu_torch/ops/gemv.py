"""Per-output-channel int8 weights and the int8 weight-matmul kernel
(counterpart of the reference's `ops/pallas_gemv.py`).

A weight w (din, dout) stores as int8 values plus one float32 scale per
output column (absmax / 127), and the scale multiplies the OUTPUT after
the product, never entering the sum. `quantize_decode_params` converts
the decode weights once at engine construction; `qmatmul` is the one
dispatch point the decode forward calls for every weight matmul: a
plain tensor takes `@`, a `QuantW` takes `int8_gemv`.

`int8_gemv` launches the hand-written CUDA kernel `csrc/int8_gemm.cu`
for CUDA tensors and uses its plain PyTorch version, `int8_gemv_plain`
(x @ dequantize_weight(w)), for CPU tensors. There is no fallback from
the kernel to the plain version on the card.

`int8_gemm_plan` is the kernel's launch geometry (rows of x a block
holds, the split of din across blocks, the threads' k-lanes, copy widths,
grid, shared memory, the splits' scratch and counters), computed on the
host and handed to the C launch function, which refuses any other.
While a step is counted (`obs/cost.py`), a launch adds its nominal work
(`int8_gemv_flops`) to the open counter.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..obs import cost as _cost
from . import _kernels
from .kernel_ops import _counter_buffer


@dataclasses.dataclass
class QuantW:
    """Per-output-channel int8 weight: q (din, dout) int8, s (1, dout)
    float32 with w ~= q * s."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a params tree (dicts, lists, and any
    non-container leaf — tensors or `QuantW`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_to(tree, device):
    """Move every tensor of a params tree (QuantW included) to `device`."""

    def move(leaf):
        if isinstance(leaf, QuantW):
            return QuantW(q=leaf.q.to(device), s=leaf.s.to(device))
        return leaf.to(device)

    return tree_map(move, tree)


def quantize_weight(w: torch.Tensor) -> QuantW:
    """Absmax int8 quantization per output channel (bitwise the
    reference's: float32 division, round half to even, clip to 127)."""
    wf = w.to(torch.float32)
    s = wf.abs().amax(dim=0, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-10)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantW(q=q, s=s)


def dequantize_weight(w: QuantW) -> torch.Tensor:
    """The float32 form the kernel is held against."""
    return w.q.to(torch.float32) * w.s


# The decode-path matmul weights quantize_decode_params converts: every
# per-block matmul (QKV/out/MLP) plus the head. Embeddings are gathers;
# layernorm params are O(dim).
_BLOCK_WEIGHTS = ("wqkv", "wq", "wkv", "wo", "w1", "w2")


def _convert_weights(params: dict, fn) -> dict:
    out = dict(params)
    out["head"] = fn(params["head"])
    blocks = []
    for blk in params["blocks"]:
        nb = dict(blk)
        for name in _BLOCK_WEIGHTS:
            if name in nb:
                nb[name] = fn(nb[name])
        blocks.append(nb)
    out["blocks"] = blocks
    return out


def quantize_decode_params(params: dict, dtype: str) -> dict:
    """One-time serving-weights conversion: "float32" passes through,
    "bfloat16" casts every float32 leaf, "int8" replaces the decode
    matmul weights with QuantW."""
    if dtype == "float32":
        return params
    if dtype == "bfloat16":
        return tree_map(lambda a: a.to(torch.bfloat16)
                        if a.dtype == torch.float32 else a, params)
    if dtype != "int8":
        raise ValueError(
            f"decode weights dtype {dtype!r}: want float32, bfloat16, "
            "or int8 (or 'auto' resolved by pick_weights_dtype first)"
        )
    return _convert_weights(params, quantize_weight)


def dequantize_decode_params(params: dict) -> dict:
    """The inverse view of quantize_decode_params(..., "int8"): every
    QuantW leaf becomes its float32 dequantized matrix, so the same
    forward runs the plain `x @ dequantize_weight(w)` product."""
    return _convert_weights(
        params, lambda w: dequantize_weight(w) if isinstance(w, QuantW) else w)


def int8_gemv_plain(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (N, din) float32 @ the
    dequantized weight -> (N, dout) float32."""
    return x.to(torch.float32) @ dequantize_weight(w)


def int8_gemv_flops(n: int, din: int, dout: int) -> int:
    """K2's nominal work (`obs/cost.py`): 2 N din dout, as FlopCounterMode
    counts `int8_gemv_plain` (the dequantizing multiply counts none)."""
    return 2 * n * din * dout


TILE_N = 32            # K2: output columns of a tile
_GROUP_ROWS = 8        # K2: rows of x of a thread's register tile
_MAX_ROWS = 32         # K2: rows of x a block holds
_SLICE_UNIT = 32       # K2: kslice is a multiple of this
_MAX_SLICE = 512       # K2: the deepest slice of din
_MAX_THREADS = 256
_LANE_CHUNK = 8        # K2: k_lanes is a multiple of it (the k-lane sum's)
_TARGET_BLOCKS = 132   # K2: blocks the din split aims for (132 SMs)
_Q_PITCH = TILE_N + 16  # K2: bytes of a q row in shared memory


class Int8GemmPlan(NamedTuple):
    """K2's launch plan. Blocks of `threads` own a tile of TILE_N output
    columns, `rows` rows of x (row_blocks of them cover N) and one split of
    din: split z takes rows [z * kslice, (z + 1) * kslice) of it, `splits`
    splits in all; grid = row_blocks * tiles * splits, the split fastest.
    Each thread holds an 8-row x 4-column tile and takes every k_lanes-th
    group of 4 rows of its split. q is copied `q_vec` bytes at a time
    (16, 8, 4 or 1), x `x_vec` (16 or 4); `smem_bytes` is the kernel's
    dynamic shared memory. With splits > 1 the partials go to `scratch`
    float32 and `counters` int32 (one per row block and tile); else both
    are 0."""
    rows: int
    row_blocks: int
    tiles: int
    kslice: int
    splits: int
    k_lanes: int
    q_vec: int
    x_vec: int
    grid: int
    threads: int
    smem_bytes: int
    scratch: int
    counters: int


def int8_gemm_plan(n: int, din: int, dout: int, *, q_ptr: int,
                   x_ptr: int) -> Int8GemmPlan:
    """The launch plan of `csrc/int8_gemm.cu` for x (n, din) float32 @ q
    (din, dout) int8, as the C launch function checks it.

    A block holds min(32, n rounded up to 8) rows of x. Where the (row
    block, column tile) pairs are fewer than _TARGET_BLOCKS, din is split
    into runs of whole 32-row slices so that about _TARGET_BLOCKS blocks
    share it (never a run shorter than one slice: a product of few tiles
    over a shallow din stays under it), and never a run deeper than
    _MAX_SLICE. q is copied 16 bytes at a time where dout % 16 == 0 (8 or
    4 bytes where only those divide dout, byte by byte where dout is odd),
    and must then be aligned to that width, else ValueError; x 16 bytes
    at a time where din % 4 == 0 and x is 16-byte aligned, else 4."""
    if min(n, din, dout) < 1:
        raise ValueError(f"int8_gemm_plan: empty product {n}x{din}x{dout}")
    rows = min(_MAX_ROWS, -(-n // _GROUP_ROWS) * _GROUP_ROWS)
    row_blocks = -(-n // rows)
    tiles = -(-dout // TILE_N)
    slices = -(-din // _SLICE_UNIT)
    base = row_blocks * tiles
    want = 1 if base >= _TARGET_BLOCKS else min(slices,
                                                -(-_TARGET_BLOCKS // base))
    want = max(want, -(-din // _MAX_SLICE))
    kslice = -(-slices // want) * _SLICE_UNIT
    splits = -(-din // kslice)
    k_lanes = min(_MAX_THREADS // rows // _LANE_CHUNK * _LANE_CHUNK,
                  kslice // 4)
    threads = rows * k_lanes
    q_vec = next(v for v in (16, 8, 4, 1) if dout % v == 0)
    if q_ptr % q_vec:
        raise ValueError(f"int8_gemm: q (0x{q_ptr:x}) must be {q_vec}-byte "
                         "aligned for the copies this dout takes; pass a "
                         "fresh tensor, not an offset view")
    x_vec = 16 if din % 4 == 0 and x_ptr % 16 == 0 else 4
    slabs = kslice * _Q_PITCH + rows * kslice * 4
    smem = max(slabs, threads * _GROUP_ROWS * 16)
    grid = base * splits
    split = splits > 1
    return Int8GemmPlan(rows, row_blocks, tiles, kslice, splits, k_lanes,
                        q_vec, x_vec, grid, threads, smem,
                        grid * rows * TILE_N if split else 0,
                        base if split else 0)


def int8_gemv(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """y = (x @ w.q) * w.s: (N, din) float32 x QuantW(din, dout) ->
    (N, dout) float32. CUDA tensors launch `csrc/int8_gemm.cu` (one
    launch, din split across blocks as `int8_gemm_plan` picks); CPU
    tensors take `int8_gemv_plain`."""
    if not x.is_cuda:
        return int8_gemv_plain(x, w)
    n, din = x.shape
    if w.q.shape[0] != din or w.s.shape != (1, w.q.shape[1]):
        raise ValueError(f"int8_gemv: x {tuple(x.shape)} vs q "
                         f"{tuple(w.q.shape)}, s {tuple(w.s.shape)}")
    if (x.dtype != torch.float32 or w.q.dtype != torch.int8
            or w.s.dtype != torch.float32):
        raise TypeError(f"int8_gemv wants float32 x, int8 q, float32 s; "
                        f"got {x.dtype}, {w.q.dtype}, {w.s.dtype}")
    if not (w.q.is_cuda and w.s.is_cuda and x.device == w.q.device == w.s.device):
        raise ValueError("int8_gemv: x, q and s must be on one CUDA device")
    if not (x.is_contiguous() and w.q.is_contiguous() and w.s.is_contiguous()):
        raise ValueError("int8_gemv: x, q and s must be contiguous")
    dout = w.q.shape[1]
    plan = int8_gemm_plan(n, din, dout, q_ptr=w.q.data_ptr(),
                          x_ptr=x.data_ptr())
    y = torch.empty((n, dout), dtype=torch.float32, device=x.device)
    work = (torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
            if plan.scratch else None)
    counters = (_counter_buffer("int8_gemm", x.device, plan.counters)
                if plan.counters else None)
    err = _kernels.lib("int8_gemm")(
        x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(),
        n, din, dout, plan.rows, plan.kslice, plan.splits, plan.k_lanes,
        plan.q_vec, plan.x_vec, plan.grid, plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check("int8_gemm", err)
    _kernels.launches["int8_gemm"] += 1
    if _cost.OPEN is not None:
        _cost.OPEN.kernel(int8_gemv_flops(n, din, dout), x, w.q, w.s, y)
    return y


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """THE decode-weight matmul dispatch: plain tensors keep `@`; QuantW
    goes to int8_gemv. Any leading batch shape (flattened around the
    kernel)."""
    if not isinstance(w, QuantW):
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    return int8_gemv(x2, w).reshape(*lead, w.q.shape[1])

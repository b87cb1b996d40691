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
"""

from __future__ import annotations

import dataclasses

import torch

from . import _kernels


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


def int8_gemv(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """y = (x @ w.q) * w.s: (N, din) float32 x QuantW(din, dout) ->
    (N, dout) float32. CUDA tensors launch `csrc/int8_gemm.cu`; CPU
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
    if w.q.data_ptr() % 4:
        raise ValueError("int8_gemv: q must be 4-byte aligned")
    dout = w.q.shape[1]
    y = torch.empty((n, dout), dtype=torch.float32, device=x.device)
    err = _kernels.lib("int8_gemm")(
        x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), y.data_ptr(),
        n, din, dout, torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check("int8_gemm", err)
    _kernels.launches["int8_gemm"] += 1
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

"""Attention helpers shared by the decode forward (counterpart of the
reference's `ops/attention.py`).

Layout as in the reference: q/k/v are (B, S, H, D). Under grouped-query
attention query head h reads kv head h // (H // Hkv).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Expand (B, S, Hkv, D) k/v to the full H query heads by repeating
    each kv head over its group (group-major, the reference's order)."""
    hkv = kv.shape[2]
    if n_heads == hkv:
        return kv
    if n_heads % hkv:
        raise ValueError(f"heads {n_heads} not a multiple of kv heads {hkv}")
    return torch.repeat_interleave(kv, n_heads // hkv, dim=2)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (rotate-half form) for x: (B, S, H, D).

    positions: (S,) absolute positions shared by every row, or (B, S)
    per-row positions (each serving slot at its own depth). Angles are
    computed in float32 whatever x's dtype; the result returns in x's
    dtype. D must be even."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    half = d // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(angles).unsqueeze(-2)
    sin = torch.sin(angles).unsqueeze(-2)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

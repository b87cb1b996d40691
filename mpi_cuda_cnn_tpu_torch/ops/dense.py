"""Dense (fully-connected) op, the `backend="torch"` twin of the
reference's `ops/dense.py` (`Layer_feedForw_full`, cnn.c:113-152, as one
batched matmul)."""

from __future__ import annotations

import torch


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (N, d_in); w: (d_in, d_out); b: (d_out,)."""
    y = x @ w
    return y if b is None else y + b

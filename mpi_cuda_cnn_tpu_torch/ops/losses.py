"""Losses and training metrics (counterpart of the reference's
`ops/losses.py`).

The reference seeds its backward pass with `outputs - onehot` after a
softmax forward (cnn.c:284-286, 141-142), which is the gradient of
softmax cross-entropy; its one progress metric is the squared error
`sum((outputs - onehot)^2)` (cnn.c:275-282). `chunked_ce_mean` is the
LM's cross-entropy fused with its head product.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor,
                          onehot: torch.Tensor) -> torch.Tensor:
    """Mean softmax-CE over the batch; d/dlogits = (softmax - onehot)/N."""
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.sum(onehot * logz, dim=-1))


def squared_error_total(probs: torch.Tensor,
                        onehot: torch.Tensor) -> torch.Tensor:
    """The reference's etotal (cnn.c:275-282), divided by the batch size
    as in the JAX package."""
    d = probs.to(torch.float32) - onehot
    return torch.sum(d * d) / probs.shape[0]


def _chunk_nll(f_c: torch.Tensor, head: torch.Tensor,
               t_c: torch.Tensor) -> torch.Tensor:
    """Sum over one S-chunk of logsumexp - target logit, float32 logits
    (bf16 operands widened: products of bf16 values are exact in float32,
    the reference's preferred_element_type)."""
    logits = f_c.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t_c[..., None]).squeeze(-1)
    return torch.sum(lse - tgt)


def chunked_ce_mean(feats: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, ce_chunk: int,
                    compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Mean next-token NLL from the final-LN features without forming the
    (B, S, V) float32 logits: the head product runs in S-chunks of
    `ce_chunk`, and each chunk reduces to one sum under
    `torch.utils.checkpoint`, so the backward recomputes the chunk's
    logits instead of keeping them (peak extra memory O(B * chunk * V)).

    feats (B, S, d); head (d, V) float32 master; targets (B, S) int."""
    b, s, _ = feats.shape
    if s % ce_chunk:
        raise ValueError(f"ce_chunk {ce_chunk} must divide seq len {s}")
    head = head.to(compute_dtype) if compute_dtype else head
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for c0 in range(0, s, ce_chunk):
        sl = slice(c0, c0 + ce_chunk)
        total = total + checkpoint(_chunk_nll, feats[:, sl], head,
                                   targets[:, sl], use_reentrant=False)
    return total / (b * s)

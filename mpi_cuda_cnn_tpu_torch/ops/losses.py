"""Losses and training metrics of the CNN (counterpart of the
reference's `ops/losses.py`).

The reference seeds its backward pass with `outputs - onehot` after a
softmax forward (cnn.c:284-286, 141-142), which is the gradient of
softmax cross-entropy; its one progress metric is the squared error
`sum((outputs - onehot)^2)` (cnn.c:275-282).
"""

from __future__ import annotations

import torch


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

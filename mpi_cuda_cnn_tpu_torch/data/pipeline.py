"""Input pipeline: normalization and one-hot (a numpy-only copy of the
reference's `data/pipeline.py`).

The reference's pipeline is three lines inside the training loop: pick a
random index (cnn.c:455), divide pixel bytes by 255 (cnn.c:457), one-hot
the label (cnn.c:462-464). The host functions here serve the per-batch
epoch; the device-resident epoch (`train/trainer.py`) does the same two
steps on the card with the same `PIXEL_SCALE`.
"""

from __future__ import annotations

import numpy as np

# The normalization contract (cnn.c:457): pixel byte / 255 -> [0,1] float.
# Shared by the host path (normalize_images) and the on-device epoch.
PIXEL_SCALE = 255.0


def ensure_channel_axis(images: np.ndarray) -> np.ndarray:
    """(N,H,W) grayscale -> (N,H,W,1); NHWC input passes through."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    return images


def normalize_images(images: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1], adding a channel axis for grayscale.
    Output layout is NHWC."""
    images = ensure_channel_axis(images)
    return images.astype(np.float32) / np.float32(PIXEL_SCALE)


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Labels -> float32 one-hot rows (cnn.c:462-464)."""
    labels = np.asarray(labels)
    out = np.zeros((len(labels), num_classes), dtype=np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out

"""Data augmentation on the device, drawn on the host (counterpart of the
reference's `data/augment.py`).

The reference has no augmentation (its input pipeline is normalize +
one-hot, cnn.c:457-464); the JAX package adds it behind `--augment`, off
by default:

  "none"        identity (the default; reference parity)
  "shift"       a random translation by up to +/-pad pixels with zero
                fill (the classic MNIST augmentation)
  "shift-flip"  shift, then a random horizontal flip

The draws are the JAX package's, bit for bit: the step's key splits into
two keys per image, the first giving the image's (row, column) offsets
into the zero-padded image by `randint(0, 2 * pad + 1)`, the second its
flip by `bernoulli(0.5)`. They come from `data/prng.py`, a numpy copy of
threefry2x32, on the host, for one step or for every step of a
device-resident chunk at once (`draw`); the pad-and-crop and the flip run
on the device (`apply`). A zero-filled shift and a flip move values
without arithmetic, so the augmented batch equals JAX's exactly.

Keys follow the JAX trainer's: `step_keys(seed, steps, shards)` is
fold_in(fold_in(key(seed), step), shard), where the shard is the rank on
the plain data-parallel step and the global canonical micro-batch on the
elastic one (`parallel/elastic.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import prng

SPECS = ("none", "shift", "shift-flip")


def step_keys(seed: int, steps, shards) -> np.ndarray:
    """fold_in(fold_in(key(seed), step), shard) for every step of `steps`
    and shard of `shards`: shape (len(steps), len(shards), 2)."""
    k = prng.fold_in(prng.key(seed), np.asarray(steps))
    return prng.fold_in(k[:, None, :], np.asarray(shards)[None, :])


@dataclasses.dataclass(frozen=True)
class Augment:
    """augment(key, x) for a batch x (B, H, W, C) on any device, with its
    host half (`draw`) and device half (`apply`) apart."""

    spec: str
    pad: int = 2

    def draw(self, keys: np.ndarray, batch: int
             ) -> tuple[np.ndarray, np.ndarray]:
        """The draws of `batch` images under each key of `keys` (..., 2):
        int32 offsets (..., batch, 2) and bool flips (..., batch)."""
        pairs = prng.split(keys, 2 * batch).reshape(
            *keys.shape[:-1], batch, 2, 2)
        offsets = prng.randint(pairs[..., 0, :], 2, 0, 2 * self.pad + 1)
        if self.spec == "shift-flip":
            flips = prng.bernoulli_half(pairs[..., 1, :])
        else:
            flips = np.zeros(pairs.shape[:-2], bool)
        return offsets, flips

    def apply(self, x: torch.Tensor, offsets: torch.Tensor,
              flips: torch.Tensor) -> torch.Tensor:
        """Shift each image of x (B, H, W, C) to its offsets (B, 2) in the
        zero-padded image, then flip it where flips (B,) is set."""
        n, h, w, _ = x.shape
        p = self.pad
        padded = F.pad(x, (0, 0, p, p, p, p)) if p else x
        rows = offsets[:, 0, None] + torch.arange(h, device=x.device)
        cols = offsets[:, 1, None] + torch.arange(w, device=x.device)
        out = padded[torch.arange(n, device=x.device)[:, None, None],
                     rows[:, :, None], cols[:, None, :]]
        if self.spec == "shift-flip":
            out = torch.where(flips[:, None, None, None], out.flip(2), out)
        return out

    def to_device(self, draws, device) -> tuple[torch.Tensor, torch.Tensor]:
        offsets, flips = draws
        return (torch.from_numpy(np.ascontiguousarray(offsets, np.int64))
                .to(device), torch.from_numpy(flips).to(device))

    def __call__(self, key: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x, *self.to_device(self.draw(key, len(x)),
                                             x.device))


def make_augment(spec: str, *, pad: int = 2) -> Augment | None:
    """The augmentation of `spec` (None for "none": the step then draws
    nothing). Raises ValueError for another spec or a negative pad."""
    if spec == "none":
        return None
    if spec not in SPECS:
        raise ValueError(f"unknown augment spec {spec!r}; one of {SPECS}")
    if pad < 0:
        raise ValueError(f"--aug-pad {pad}: want >= 0")
    return Augment(spec, pad)

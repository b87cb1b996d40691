"""Functional CNN layers (counterpart of the reference's
`models/layers.py`).

A model is data (a tuple of stateless layer descriptors) plus a params
tree: a list with one dict of tensors per layer, the same tree the JAX
package builds, so `convert.params_from_jax` maps one onto the other
leaf for leaf. Activations are NHWC and conv weights HWIO throughout, as
there: fc1 of reference_cnn reads its 1,568 inputs in H·W·C order.

Each layer implements
    init(gen, in_shape, initializer) -> (params, out_shape)
    apply(params, x, backend) -> y
with per-sample shapes (H, W, C) or (features,). `backend` selects
"torch" (PyTorch's own ops, `ops/conv.py`, `ops/dense.py`) or "cuda"
(the hand-written kernels of `ops/kernel_ops.py`), as the reference's
layers switch between "xla" and "pallas".
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.activations import ACTIVATIONS
from ..ops.conv import conv2d
from ..ops.dense import dense
from ..ops.gemv import tree_map
from ..ops.kernel_ops import conv2d_kernel, dense_kernel

BACKENDS = ("torch", "cuda")


def _apply_activation(name: str | None, x: torch.Tensor) -> torch.Tensor:
    return ACTIVATIONS[name](x)


@dataclasses.dataclass(frozen=True)
class Conv:
    """2-D convolution + bias + activation (cnn.c:175-210, 328-343)."""

    features: int
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    activation: str | None = "relu"

    def init(self, gen, in_shape, initializer):
        h, w, c = in_shape
        params = {
            "w": initializer(gen, (self.kernel, self.kernel, c, self.features)),
            "b": torch.zeros((self.features,), dtype=torch.float32),
        }
        oh = (h + 2 * self.padding - self.kernel) // self.stride + 1
        ow = (w + 2 * self.padding - self.kernel) // self.stride + 1
        return params, (oh, ow, self.features)

    def apply(self, params, x, backend="torch"):
        if backend == "cuda":
            y = conv2d_kernel(x, params["w"], self.stride, self.padding)
        else:
            y = conv2d(x, params["w"], stride=self.stride,
                       padding=self.padding)
        return _apply_activation(self.activation, y + params["b"])


@dataclasses.dataclass(frozen=True)
class Dense:
    """Fully-connected + bias + activation (cnn.c:113-152, 318-326).
    Accepts (N, d) or unflattened (N, H, W, C) input, read in NHWC order."""

    features: int
    activation: str | None = "tanh"

    def init(self, gen, in_shape, initializer):
        d_in = math.prod(in_shape)
        params = {
            "w": initializer(gen, (d_in, self.features)),
            "b": torch.zeros((self.features,), dtype=torch.float32),
        }
        return params, (self.features,)

    def apply(self, params, x, backend="torch"):
        x = x.reshape(x.shape[0], -1)
        if backend == "cuda":
            y = dense_kernel(x, params["w"], params["b"])
        else:
            y = dense(x, params["w"], params["b"])
        return _apply_activation(self.activation, y)


def _pool(x: torch.Tensor, window: int, stride: int, kind: str) -> torch.Tensor:
    """Pooling over NHWC. Non-overlapping windows (stride == window, the
    only form the presets use) are a reshape + reduce, whose max gradient
    splits evenly among ties as the reference's does; other windows go
    through PyTorch's VALID pooling."""
    n, h, w, c = x.shape
    if stride == window and h % window == 0 and w % window == 0:
        r = x.reshape(n, h // window, window, w // window, window, c)
        return r.amax(dim=(2, 4)) if kind == "max" else r.mean(dim=(2, 4))
    pool = F.max_pool2d if kind == "max" else F.avg_pool2d
    return pool(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class MaxPool:
    """Max pooling (beyond the reference; the LeNet-5/VGG presets)."""

    window: int = 2
    stride: int | None = None

    def init(self, gen, in_shape, initializer):
        s = self.stride or self.window
        h, w, c = in_shape
        return {}, ((h - self.window) // s + 1, (w - self.window) // s + 1, c)

    def apply(self, params, x, backend="torch"):
        return _pool(x, self.window, self.stride or self.window, "max")


@dataclasses.dataclass(frozen=True)
class AvgPool:
    """Average pooling (classic LeNet-5 subsampling)."""

    window: int = 2
    stride: int | None = None

    def init(self, gen, in_shape, initializer):
        s = self.stride or self.window
        h, w, c = in_shape
        return {}, ((h - self.window) // s + 1, (w - self.window) // s + 1, c)

    def apply(self, params, x, backend="torch"):
        return _pool(x, self.window, self.stride or self.window, "avg")


@dataclasses.dataclass(frozen=True)
class Flatten:
    def init(self, gen, in_shape, initializer):
        return {}, (math.prod(in_shape),)

    def apply(self, params, x, backend="torch"):
        return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class Residual:
    """y = act(body(x) + shortcut(x)); the shortcut is the identity when
    the body keeps the shape, else a 1x1 strided projection conv."""

    body: tuple
    activation: str | None = "relu"

    def init(self, gen, in_shape, initializer):
        body_params = []
        shape = in_shape
        for layer in self.body:
            p, shape = layer.init(gen, shape, initializer)
            body_params.append(p)
        params = {"body": body_params}
        if shape != in_shape:
            proj = Conv(shape[-1], kernel=1,
                        stride=self._proj_stride(in_shape, shape), padding=0,
                        activation=None)
            params["proj"], _ = proj.init(gen, in_shape, initializer)
        return params, shape

    @staticmethod
    def _proj_stride(in_shape, out_shape) -> int:
        """Stride s such that a 1x1 VALID conv maps (h,w) -> (oh,ow)."""
        h, w, _ = in_shape
        oh, ow, _ = out_shape
        for s in range(1, h + 1):
            if (h - 1) // s + 1 == oh and (w - 1) // s + 1 == ow:
                return s
        raise ValueError(f"Residual body maps {in_shape} -> {out_shape}, "
                         "which a 1x1 strided projection cannot match")

    def apply(self, params, x, backend="torch"):
        y = x
        for layer, p in zip(self.body, params["body"]):
            y = layer.apply(p, y, backend=backend)
        if "proj" in params:
            proj = Conv(y.shape[-1], kernel=1,
                        stride=self._proj_stride(tuple(x.shape[1:]),
                                                 tuple(y.shape[1:])),
                        padding=0, activation=None)
            x = proj.apply(params["proj"], x, backend=backend)
        return _apply_activation(self.activation, y + x)


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool:
    """Spatial global average -> (N, C)."""

    def init(self, gen, in_shape, initializer):
        return {}, (in_shape[-1],)

    def apply(self, params, x, backend="torch"):
        return x.mean(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class Sequential:
    """A feed-forward stack (cnn.c:249-268); the final Dense's activation
    is None, the softmax lives in the loss."""

    layers: tuple
    input_shape: tuple[int, ...]
    name: str = "model"

    def init(self, gen: torch.Generator, initializer,
             device: torch.device | str = "cpu") -> list[dict]:
        """Params drawn in layer order from `gen` (on the CPU), then
        moved to `device`."""
        params = []
        shape = self.input_shape
        for layer in self.layers:
            p, shape = layer.init(gen, shape, initializer)
            params.append(p)
        return tree_map(lambda t: t.to(device), params)

    def apply(self, params: list[dict], x: torch.Tensor, *,
              backend: str = "torch",
              compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """x: (N, H, W, C) -> float32 logits (N, num_classes).

        compute_dtype=torch.bfloat16 casts x and every param to bf16 on
        entry, so every layer computes in bf16 (the kernels accumulate in
        float32 and round once) and autograd returns float32 gradients
        for float32 params through the cast; the logits come back in
        float32 for the loss (the reference's `Sequential.apply`)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
        if compute_dtype is not None:
            x = x.to(compute_dtype)
            params = tree_map(lambda t: t.to(compute_dtype), params)
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x, backend=backend)
        return x.float()

    def num_params(self, params: list[dict]) -> int:
        return sum(t.numel() for t in tree_leaves(params))


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a params tree, in a fixed order (dict keys sorted,
    as `jax.tree.leaves` orders them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]

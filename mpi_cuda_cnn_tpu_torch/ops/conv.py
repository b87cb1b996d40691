"""2-D convolution in PyTorch's own ops: the `backend="torch"` twin of
the reference's `ops/conv.py`, and the oracle of the CUDA conv kernels.

The public functions take and return the reference's NHWC activations
and HWIO weights, so both packages compare like with like; inside they
permute to PyTorch's NCHW/OIHW for `F.conv2d`. On the card TF32 must be
off for float32 parity (`_device.disable_tf32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           stride: int | tuple[int, int] = 1,
           padding: int | tuple[int, int] = 0) -> torch.Tensor:
    """x: (N,H,W,Cin); w: (kh,kw,Cin,Cout). Returns (N,Ho,Wo,Cout)."""
    return _nhwc(F.conv2d(_nchw(x), _oihw(w), stride=_pair(stride),
                          padding=_pair(padding)))


def conv2d_input_grad(g: torch.Tensor, w: torch.Tensor, *,
                      stride: int | tuple[int, int],
                      padding: int | tuple[int, int],
                      input_hw: tuple[int, int]) -> torch.Tensor:
    """d(loss)/d(input) given the cotangent g: the transposed conv, with
    the output padding that recovers input_hw (cnn.c:228-236)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    kh, kw = w.shape[0], w.shape[1]
    ih, iw = input_hw
    oh, ow = g.shape[1], g.shape[2]
    extra = (ih - ((oh - 1) * sh + kh - 2 * ph),
             iw - ((ow - 1) * sw + kw - 2 * pw))
    return _nhwc(F.conv_transpose2d(_nchw(g), _oihw(w), stride=(sh, sw),
                                    padding=(ph, pw), output_padding=extra))


def conv2d_kernel_grad(x: torch.Tensor, g: torch.Tensor, *,
                       stride: int | tuple[int, int],
                       padding: int | tuple[int, int]) -> torch.Tensor:
    """d(loss)/d(kernel) given the input x and the cotangent g
    (cnn.c:238-242). The kernel extent is what the reference's form
    implies, H + 2p - (Ho - 1) * stride: where (H + 2p - kh) is not a
    multiple of the stride that is larger than the layer's kernel, and
    the extra taps are the gradient of weights the conv does not have
    (take [:kh, :kw])."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    n, h, wd, cin = x.shape
    _, oh, ow, cout = g.shape
    kh = h + 2 * ph - (oh - 1) * sh
    kw = wd + 2 * pw - (ow - 1) * sw
    dw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, kh, kw), _nchw(g),
                                     stride=(sh, sw), padding=(ph, pw))
    return dw.permute(2, 3, 1, 0)

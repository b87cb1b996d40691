"""Device resolution for the port's entry points.

Everything runs on `cuda` unless the caller asks for the CPU. A request
for CUDA on a machine without a GPU raises instead of quietly running
on the CPU. On the card, TF32 is switched off for both matmuls and
cuDNN, so float32 work stays float32 and parity with the reference
holds at the stated tolerances.
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions (PyTorch lets cuDNN use
    TF32 by default, which keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None`/"auto"/"cuda" -> the current CUDA device; "cpu" -> the CPU.
    Raises RuntimeError when CUDA is asked for and none is available."""
    if device is None or device == "auto":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False — pass device='cpu' (--device cpu) to run on the CPU"
            )
        disable_tf32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: want 'cuda' or 'cpu'")
    return dev

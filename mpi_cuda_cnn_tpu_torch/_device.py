"""Device resolution for the port's entry points.

Everything runs on `cuda` unless the caller asks for the CPU. A request
for CUDA on a machine without a GPU raises instead of quietly running
on the CPU. A rank of a data-parallel run resolves "cuda" to its own
card (`local_card`): cuda:LOCAL_RANK under `torchrun`, cuda:0 where the
launcher shows the process only its own card, or the card its launcher
made current (`parallel.distributed.run_ranks`). On the card, TF32 is
switched off for both matmuls and cuDNN, so float32 work stays float32
and parity with the reference holds at the stated tolerances.
"""

from __future__ import annotations

import os

import torch


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions (PyTorch lets cuDNN use
    TF32 by default, which keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def local_card() -> torch.device:
    """This process's card: cuda:LOCAL_RANK when the environment names a
    local rank (cuda:0 when the process sees one card only: its
    launcher gave it its own), else the current CUDA device."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda", torch.cuda.current_device())
    visible = torch.cuda.device_count()
    if visible == 1:
        return torch.device("cuda", 0)
    if int(local) >= visible:
        raise RuntimeError(f"LOCAL_RANK {local}, but this process sees "
                           f"{visible} cards")
    return torch.device("cuda", int(local))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None`/"auto"/"cuda" -> this process's card (`local_card`); "cpu"
    -> the CPU. Raises RuntimeError when CUDA is asked for and none is
    available."""
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
            dev = local_card()
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: want 'cuda' or 'cpu'")
    return dev

"""Device memory telemetry (counterpart of the reference's
`obs/device.py`), from PyTorch's caching allocator: `bytes_in_use` is
the memory allocated now, `peak_bytes_in_use` the most allocated since
the process began (or since `torch.cuda.reset_peak_memory_stats`), and
`bytes_limit` the card's total. The CPU has no such stats: null, as the
reference gives null for a device without them.
"""

from __future__ import annotations

import torch


def device_memory_stats(device: torch.device) -> dict | None:
    """The allocator's stats of a CUDA device, or None."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_limit": int(torch.cuda.get_device_properties(device)
                               .total_memory)}


def memory_snapshot(devices) -> list[dict]:
    """One {"id", "platform", "stats"} entry per device: the "memory"
    record's `devices` (platform "gpu" or "cpu", the reference's
    names)."""
    out = []
    for d in devices:
        d = torch.device(d)
        out.append({"id": d.index or 0,
                    "platform": "gpu" if d.type == "cuda" else d.type,
                    "stats": device_memory_stats(d)})
    return out


def emit_step_telemetry(metrics, timer, steps: int, *, devices,
                        **fields) -> None:
    """The "step_phases" (the timer's per-step phases) and "memory"
    records of an interval of `steps` steps, when `metrics` has its JSONL
    file open; nothing otherwise."""
    if metrics is None or not metrics.jsonl_enabled or steps <= 0:
        return
    metrics.log("step_phases", steps=steps, phases_ms=timer.phases_ms(),
                **fields)
    metrics.log("memory", devices=memory_snapshot(devices), **fields)

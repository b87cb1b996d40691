"""The counted step: FLOPs, bytes and collectives of one training step,
counted while it runs (counterpart of the reference's `obs/cost.py`,
which reads XLA's cost analysis of a compiled program; the port has no
compiled program, so it counts a real step).

`count_step()` is a context manager around one step of the trainer:

- FLOPs: the ATen ops the step dispatches, counted by
  `torch.utils.flop_counter.FlopCounterMode` (display off; ops with no
  formula, the elementwise ones, count 0), plus the nominal work of each
  hand-written kernel the step launches. The kernels launch through
  `ctypes` (`ops/_kernels.py`), out of that mode's sight, so each
  wrapper adds its work to the open counter (`OPEN`), once per function
  it computes: the count the mode gives the kernel's plain version at
  the same shapes (`2mnk` a product, the padding taps of a conv
  included, the full S x S square of attention, causal or not; the
  causal half is `train/lm.py`'s `lm_flops_per_token`, not here). The
  same config therefore counts the same FLOPs on the CPU's plain path
  and on the card's kernel path.
- Bytes: the operand and result bytes of every op counted, the kernels'
  included, unfused (views and allocations move none). It is not XLA's
  post-fusion figure.
- Collectives: the step's delta of `parallel.dp.collectives`, under the
  reference's HLO spellings (`HLO_NAMES`), so that `report` and
  `compare` read one set of keys from both packages' files. A world of
  one makes none.
- Donation and memory: the update is in place, so `aliased_outputs` is
  0 and `alias_bytes` null; `temp_bytes` is null (taking it would reset
  the allocator's peak that the `memory` records read).

Counting observes: the step's arithmetic is the uncounted step's, bit
for bit. The trainers keep the counted step out of their step-phase
attribution (`StepTimer.exclude`), as the reference keeps its compile,
and out of the steps that attribution is a mean over.

`PEAK_TFLOPS` is the card's data-sheet dense peak, the denominator of
`mfu`; `peak_flops` gives None off the card, so `report`'s mfu is null
there.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# Dense peaks of the H100 SXM (data sheet): bf16 on the tensor cores,
# float32 outside them (TF32 off). The one table: `lm-bench` reads it.
PEAK_TFLOPS: dict[str, float] = {
    "h100_sxm_bf16": 989.0,
    "h100_sxm_f32": 67.0,
}

# `parallel.dp.collectives` kinds -> the reference's HLO instruction
# names. A point-to-point shift is one collective-permute on each rank
# it touches: its send, or its receive (`collective_counts`).
HLO_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

# Ops that move no bytes: allocations (the kernels' outputs among them).
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "detach",
                       "lift_fresh", "_local_scalar_dense"})


def peak_flops(dtype: str = "bfloat16", *, backend: str | None = None,
               override_tflops: float | None = None) -> float | None:
    """Peak FLOP/s for the MFU denominator, or None off the card. An
    override names the card's bf16 peak; float32 scales by the data
    sheet's ratio."""
    if override_tflops is not None:
        bf16 = override_tflops
    elif (backend or ("cuda" if torch.cuda.is_available() else "cpu")) \
            == "cuda":
        bf16 = PEAK_TFLOPS["h100_sxm_bf16"]
    else:
        return None
    if dtype in ("bfloat16", "bf16"):
        return bf16 * 1e12
    return (bf16 * 1e12 * PEAK_TFLOPS["h100_sxm_f32"]
            / PEAK_TFLOPS["h100_sxm_bf16"])


def mfu(flops: float | None, seconds: float, peak: float | None
        ) -> float | None:
    """Model FLOPs utilization; None whenever a factor is unknown."""
    if not flops or not peak or seconds <= 0:
        return None
    return flops / seconds / peak


def _nbytes(tree) -> int:
    leaves = tree if isinstance(tree, (list, tuple)) else [tree]
    total = 0
    for x in leaves:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            total += _nbytes(x)
    return total


class _ByteMode(TorchDispatchMode):
    """Adds the operand and result bytes of every op but the views and
    the allocations to `count.bytes`."""

    def __init__(self, count: StepCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(func, "is_view", False) and \
                func.overloadpacket.__name__ not in _NO_BYTES:
            self.count.bytes += (_nbytes(args) + _nbytes(list(kwargs.values()))
                                 + _nbytes(out))
        return out


class StepCount:
    """What one counted step did: `flops` and `bytes` of the kernels
    (`kernel`), and after `count_step` exits, the totals."""

    def __init__(self):
        self.kernel_flops = 0
        self.bytes = 0
        self.flops = 0
        self.collectives: dict[str, int] = {}

    def kernel(self, flops: int, *tensors: torch.Tensor | None,
               nbytes: int = 0) -> None:
        """One kernel's function: its nominal FLOPs and the bytes of
        its operands and results (None entries skipped), plus `nbytes`
        read through an index (the pages of a block table)."""
        self.kernel_flops += flops
        self.bytes += nbytes + sum(t.numel() * t.element_size()
                                   for t in tensors if t is not None)


# The counter of the step being counted, or None (the wrappers' one
# check when nothing is counted).
OPEN: StepCount | None = None


def collective_counts(before: dict[str, int], after: dict[str, int]
                      ) -> dict[str, int]:
    """The collectives made between two readings of
    `parallel.dp.collectives`, under the HLO names (zeros left out)."""
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    out: dict[str, int] = {}
    for kind, n in delta.items():
        if n and kind in HLO_NAMES:
            out[HLO_NAMES[kind]] = out.get(HLO_NAMES[kind], 0) + n
        elif n and kind not in ("send", "recv"):
            out[kind] = out.get(kind, 0) + n
    permutes = max(delta.get("send", 0), delta.get("recv", 0))
    if permutes:
        out["collective-permute"] = permutes
    return out


@contextlib.contextmanager
def count_step():
    """Count the work dispatched inside the block (one step): yields a
    `StepCount` whose `flops`, `bytes` and `collectives` are the step's
    once the block exits. Counts do not nest."""
    global OPEN
    from ..parallel import dp

    if OPEN is not None:
        raise RuntimeError("count_step: a step is already being counted")
    count = StepCount()
    before = dict(dp.collectives)
    flop_mode = FlopCounterMode(display=False)
    OPEN = count
    try:
        with flop_mode, _ByteMode(count):
            yield count
    finally:
        OPEN = None
    count.flops = flop_mode.get_total_flops() + count.kernel_flops
    count.collectives = collective_counts(before, dict(dp.collectives))


class ProgramLog:
    """A trainer's `program` records: one per label, at the label's first
    step, which runs counted where the JSONL sink is open (`dispatch`).
    `configured` says a sink is open on some rank of the world (the
    writer's), so that every rank knows which step is counted
    (`first`)."""

    def __init__(self, metrics, device: torch.device, compute_dtype: str,
                 *, configured: bool = False):
        self.metrics = metrics
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.on = bool(metrics.jsonl_enabled or configured)
        self.done: set[str] = set()

    def first(self, label: str) -> bool:
        """Whether the next step of `label` is its counted first one."""
        return self.on and label not in self.done

    def dispatch(self, label: str, timer, counting: str = "program"):
        """The timer's "dispatch" phase of a step of `label`, or for its
        first step where the sink is open, the step counted, out of the
        timer's phases and step count and waited for on the card, then
        its record logged. counting="static-body" marks the
        device-resident epoch, whose one counted step stands for each
        step of the dispatch (steps_per_dispatch=1), as the reference
        marks a scanned program."""
        if not self.first(label):
            return timer.phase("dispatch")
        self.done.add(label)
        if not self.metrics.jsonl_enabled:
            return timer.phase("dispatch")
        return self._counted(label, timer, counting=counting)

    @contextlib.contextmanager
    def _counted(self, label: str, timer, *, counting: str = "program"):
        with timer.exclude(steps=1):
            with count_step() as count:
                yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        # the reference's record shape; nothing is aliased (the update
        # is in place) and no scratch size is taken
        self.metrics.log(
            "program", label=label, steps_per_dispatch=1, counting=counting,
            backend=self.device.type, compute_dtype=self.compute_dtype,
            flops=float(count.flops), bytes=float(count.bytes),
            collectives=count.collectives, aliased_outputs=0,
            alias_bytes=None, temp_bytes=None)

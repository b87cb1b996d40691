#!/usr/bin/env python3
"""Wall times of the two trainers' step loops on the card, for the
checkout it is run from (it imports that checkout's `chip_smoke.py` and
port, so it times another commit's loops when run from an unpacked copy
of it):

- `cnn device`: `train-bench --use-kernels`, reference_cnn on 60,000
  synthetic samples, the device-resident route (the default path: no
  checkpoint, no fault plan, no NaN guard); one warm-up epoch, then the
  median of 2 measured epochs;
- `cnn per_batch`: the same epochs through `Trainer` with `scan` off (one
  host batch a step), the same warm-up and median;
- `lm`: `LMTrainer.train()` at chip_smoke's flagship (d512 x 8, seq 2048,
  batch 8, float32, flash attention), LM_STEPS steps with no log (no host
  sync in the loop), after a 2-step warm-up trainer; the trainer's own
  tokens/s (steps x tokens over the loop's wall time, ending in a sync).

Where the checkout has the NaN guard (`mpi_cuda_cnn_tpu_torch/faults.py`),
`cnn per_batch` and `lm` run again under `--nan-policy skip` (a device
copy of the state before each step, a device check after it, one host
read a step), and the guarded run's final params must equal the
unguarded run's bit for bit (no step goes non-finite here).

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/loop_times.py $t)
    done

One line per measurement, tagged; the first is the card's name and power
limit. Each line also carries `params_crc`, a crc32 of the run's final
params (equal across two checkouts: the same results bit for bit), and
the CNN lines the kernel launches a step of their measured epochs. Needs
a CUDA device; it builds that checkout's kernels on first use.
"""

from __future__ import annotations

import importlib.util
import os
import statistics
import sys
import time
import zlib

NUM_TRAIN = 60_000
EPOCHS = 2
LM_STEPS = 10


def cnn_epochs(torch, ds, scan: bool, nan_policy: str | None):
    """Warm-up epoch 0, then epochs 1..EPOCHS: (wall seconds of each
    measured epoch, the final params on the host, the kernel launches
    of the measured epochs)."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.config import Config
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    kw = {} if nan_policy is None else {"nan_policy": nan_policy}
    cfg = Config(model="reference_cnn", epochs=1 + EPOCHS, batch_size=32,
                 lr=0.1, seed=0, device="cuda", use_kernels=True,
                 log_every=0, eval_every=0, scan=scan, **kw)
    tr = Trainer(get_model("reference_cnn"), ds, cfg,
                 metrics=MetricsLogger(echo=False))
    tr.run_epoch(0)
    _kernels.reset_launches()
    times = []
    for epoch in range(1, 1 + EPOCHS):
        t0 = time.perf_counter()
        tr.run_epoch(epoch)            # ends in a device sync
        times.append(time.perf_counter() - t0)
    return (times, [t.detach().cpu() for t in tr.leaves],
            {k: v for k, v in _kernels.launches.items() if v})


def crc(params: list) -> int:
    """crc32 of the params' bytes, in order."""
    c = 0
    for t in params:
        c = zlib.crc32(t.float().contiguous().numpy().tobytes(), c)
    return c


def lm_run(torch, cs, nan_policy: str | None):
    """The flagship's tokens/s over LM_STEPS steps, its tokens a step and
    its final params on the host."""
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    guard = [] if nan_policy is None else ["--nan-policy", nan_policy]

    def trainer(steps: int):
        return LMTrainer(parse_lm_args(cs.LM_MODEL_ARGS + guard + [
            "--attn-impl", "flash", "--steps", str(steps),
            "--warmup-steps", "2", "--log-every", "0"]),
            metrics=MetricsLogger(echo=False))

    trainer(3).train()                 # warm-up: the kernels, the allocator
    tr = trainer(LM_STEPS)
    result = tr.train()
    params = [t.detach().cpu() for t in tree_leaves(tr.state["params"])]
    tokens = tr.cfg.batch_size * tr.cfg.seq_len
    del tr
    torch.cuda.empty_cache()
    return result.tokens_per_s, tokens, params


def same(a: list, b: list) -> bool:
    return all(x.equal(y) for x, y in zip(a, b, strict=True))


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes

    if not torch.cuda.is_available():
        print("loop_times: no CUDA device", file=sys.stderr)
        return 1
    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    guarded = importlib.util.find_spec("mpi_cuda_cnn_tpu_torch.faults")
    print(cs.nvidia_smi(), flush=True)
    ds = synthetic_stripes(num_train=NUM_TRAIN, num_test=32)
    steps = NUM_TRAIN // 32

    def cnn_line(route: str, policy: str, times: list, params: list,
                 launches: dict) -> None:
        epoch_s = statistics.median(times)
        per_step = {k: v / (steps * EPOCHS) for k, v in launches.items()}
        print(f"{tag} cnn {route} nan_policy={policy} epoch_s {epoch_s:.4f} "
              f"step_ms {1e3 * epoch_s / steps:.4f} epochs_s "
              f"{[round(t, 4) for t in times]} params_crc {crc(params)} "
              f"launches_per_step {per_step}", flush=True)

    cnn_line("device", "off", *cnn_epochs(torch, ds, scan=True,
                                         nan_policy=None))
    times, plain, launches = cnn_epochs(torch, ds, scan=False,
                                        nan_policy=None)
    cnn_line("per_batch", "off", times, plain, launches)
    if guarded:
        times, params, launches = cnn_epochs(torch, ds, scan=False,
                                             nan_policy="skip")
        cnn_line("per_batch", "skip", times, params, launches)
        if not same(params, plain):
            raise AssertionError("cnn: the guarded epochs' params differ")

    def lm_line(policy: str, tok_s: float, tokens: int, params) -> None:
        print(f"{tag} lm flagship f32 flash nan_policy={policy} tokens_per_s "
              f"{tok_s:.1f} step_ms {1e3 * tokens / tok_s:.3f} params_crc "
              f"{crc(params)}", flush=True)

    tok_s, tokens, plain = lm_run(torch, cs, None)
    lm_line("off", tok_s, tokens, plain)
    if guarded:
        tok_s, tokens, params = lm_run(torch, cs, "skip")
        lm_line("skip", tok_s, tokens, params)
        if not same(params, plain):
            raise AssertionError("lm: the guarded run's params differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())

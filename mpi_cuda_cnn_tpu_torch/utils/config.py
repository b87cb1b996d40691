"""Config and flags of the CNN `train` command (counterpart of the
reference's `utils/config.py`).

The reference has no flag system: 4 positional IDX paths (cnn.c:408-412)
and every hyperparameter compiled in (rate=0.1 cnn.c:446, nepoch=10
cnn.c:448, batch_size=32 cnn.c:449, seed 0 cnn.c:413). This module keeps
the 4-positional-path form (exit 100 on a wrong count) while exposing
those as flags, with the JAX package's names and defaults.
`--use-kernels` takes the place of `--use-pallas`: the hand-written CUDA
kernels instead of PyTorch's own ops (off by default, as there).

The flags of features this port does not have yet stay, so that a run
asking for one stops at once: `check_supported` raises
NotImplementedError naming the ROADMAP queue entry that will bring it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


@dataclasses.dataclass
class Config:
    # Data: either a registered dataset name, or the reference's 4 IDX paths.
    dataset: str = "synthetic"
    data_dir: str | None = None
    train_images: str | None = None
    train_labels: str | None = None
    test_images: str | None = None
    test_labels: str | None = None

    # Model / training — defaults are the reference's compiled-in constants.
    model: str = "reference_cnn"  # see models.presets
    epochs: int = 10              # cnn.c:448
    lr: float = 0.1               # cnn.c:446
    batch_size: int = 32          # cnn.c:449 (accumulator period)
    momentum: float = 0.0
    lr_schedule: str = "constant"  # constant | cosine
    grad_clip: float = 0.0        # global-norm clip; 0 disables
    seed: int = 0                 # cnn.c:413 srand(0)
    init: str = "normal"          # normal | irwin_hall | he
    augment: str = "none"         # refused unless "none"

    # Numerics: float32 only in this port so far.
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # Execution.
    device: str = "auto"          # auto (= cuda) | cuda | cpu
    num_devices: int = 0          # 0 or 1: one device
    mesh_shape: str = "data"      # "data" or "data:1" only
    fsdp: bool = False
    use_kernels: bool = False     # hand-written CUDA kernels (ops/kernel_ops)
    remat: bool = False
    grad_accum: int = 1
    scan: bool = True             # device-resident epochs: the uint8 set
                                  # staged on the device once; off = the
                                  # host normalizes and sends each batch
    scan_max_bytes: int = 2 << 30  # larger datasets stream per batch

    # Aux subsystems (refused unless off).
    checkpoint_dir: str | None = None
    resume: bool = False
    max_restarts: int = 0
    nan_policy: str = "off"
    fault_plan: str | None = None
    elastic_width: int = 0
    log_every: int = 100          # steps; <= 0 = no logging inside an epoch
    profile_dir: str | None = None
    metrics_jsonl: str | None = None
    eval_every: int = 1           # epochs


# (field, value that means "off", ROADMAP queue E item, what it is)
_REFUSED = (
    ("fsdp", False, 1, "FSDP"),
    ("checkpoint_dir", None, 2, "checkpointing"),
    ("resume", False, 2, "checkpoint resume"),
    ("nan_policy", "off", 3, "the NaN guard"),
    ("fault_plan", None, 3, "fault plans"),
    ("max_restarts", 0, 3, "the crash supervisor"),
    ("grad_accum", 1, 4, "gradient accumulation"),
    ("remat", False, 4, "rematerialization"),
    ("param_dtype", "float32", 4, "bf16 params"),
    ("compute_dtype", "float32", 4, "bf16 compute"),
    ("augment", "none", 5, "augmentation"),
    ("metrics_jsonl", None, 6, "the JSONL metrics sink"),
    ("profile_dir", None, 6, "profiler traces"),
    ("elastic_width", 0, 7, "elastic width"),
)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a feature of the reference's CNN
    trainer that this port does not have yet (ROADMAP queue E)."""
    if cfg.num_devices > 1 or cfg.mesh_shape not in ("data", "data:1"):
        raise NotImplementedError(
            f"num_devices={cfg.num_devices}, mesh_shape={cfg.mesh_shape!r}: "
            "only one device is ported (data parallelism is ROADMAP queue "
            "E item 1)")
    for name, off, item, what in _REFUSED:
        if getattr(cfg, name) != off:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={getattr(cfg, name)!r}: {what} is not ported yet "
                f"(ROADMAP queue E item {item})")


def _add_flag(p: argparse.ArgumentParser, name: str, default) -> None:
    flag = "--" + name.replace("_", "-")
    if isinstance(default, bool):
        p.add_argument(flag, action=argparse.BooleanOptionalAction,
                       default=default)
        return
    p.add_argument(flag, type=str if default is None else type(default),
                   default=default)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch train",
        description="CNN trainer on one CUDA device (the PyTorch port of "
                    "mpi_cuda_cnn_tpu's train command).",
    )
    # The reference contract: exactly 4 positional IDX paths (cnn.c:408-411).
    p.add_argument("idx_paths", nargs="*", metavar="IDX",
                   help="train-images train-labels test-images test-labels "
                        "(the reference CLI form; omit to use --dataset)")
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.name in ("train_images", "train_labels", "test_images",
                      "test_labels"):
            continue
        _add_flag(p, f.name, getattr(defaults, f.name))
    return p


def parse_args(argv: list[str] | None = None) -> Config:
    kwargs = vars(build_parser().parse_args(argv))
    idx_paths = kwargs.pop("idx_paths")
    cfg = Config(**kwargs)
    if idx_paths:
        if len(idx_paths) != 4:
            # The reference exits 100 on bad argc (cnn.c:412) — keep the code.
            print("expected 4 IDX paths: train-images train-labels "
                  "test-images test-labels", file=sys.stderr)
            raise SystemExit(100)
        (cfg.train_images, cfg.train_labels, cfg.test_images,
         cfg.test_labels) = idx_paths
        cfg.dataset = "idx"
    return cfg

"""Config and flags of the CNN `train` and the LM `lm` commands
(counterpart of the reference's `utils/config.py`).

The reference has no flag system: 4 positional IDX paths (cnn.c:408-412)
and every hyperparameter compiled in (rate=0.1 cnn.c:446, nepoch=10
cnn.c:448, batch_size=32 cnn.c:449, seed 0 cnn.c:413). This module keeps
the 4-positional-path form (exit 100 on a wrong count) while exposing
those as flags, with the JAX package's names and defaults.
`--use-kernels` takes the place of `--use-pallas`: the hand-written CUDA
kernels instead of PyTorch's own ops (off by default, as there).

The flags of features this port does not have yet stay, so that a run
asking for one stops at once: `check_supported` (CNN, ROADMAP queue E)
and `check_lm_supported` (LM, queue F) raise NotImplementedError naming
the ROADMAP queue entry that will bring it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


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

    # Numerics: float32 params; compute in float32 or bfloat16.
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # float32 | bfloat16

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


# --compute-dtype of both trainers -> the dtype the forward casts to
# (None: float32, no cast).
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

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
    ("augment", "none", 5, "augmentation"),
    ("metrics_jsonl", None, 6, "the JSONL metrics sink"),
    ("profile_dir", None, 6, "profiler traces"),
    ("elastic_width", 0, 7, "elastic width"),
)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a feature of the reference's CNN
    trainer that this port does not have yet (ROADMAP queue E), and
    ValueError for a compute dtype other than float32 or bfloat16."""
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
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"--compute-dtype={cfg.compute_dtype!r}: want one "
                         f"of {'|'.join(COMPUTE_DTYPES)}")


@dataclasses.dataclass
class LMConfig:
    """Config of the `lm` command (train/lm_trainer.py): the reference's
    `LMConfig` fields, names and defaults."""

    corpus: str = "self"          # self | synthetic | path to a text file
    dim: int = 256
    depth: int = 4
    heads: int = 8
    kv_heads: int = 0             # 0 = heads (MHA); < heads = GQA
    pos: str = "learned"          # learned | rope
    seq_len: int = 256
    moe_experts: int = 0          # refused unless 0 (queue F item 2)
    moe_top_k: int = 1
    moe_dispatch_chunk: int = 0   # refused unless 0 (queue F item 2)
    moe_dispatch_dtype: str | None = None  # refused unless unset
    steps: int = 200
    batch_size: int = 8
    lr: float = 3e-4
    lr_schedule: str = "cosine"
    warmup_steps: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 0.0        # global-norm clip; 0 disables
    grad_accum: int = 1           # refused unless 1 (queue F item 3)
    seed: int = 0
    donate: bool = True           # no-op here: the update is in place

    compute_dtype: str = "float32"   # float32 | bfloat16
    attn_impl: str = "auto"          # auto | flash | oracle
    remat: bool = False
    fsdp: bool = False               # refused (queue F item 1)
    ce_chunk: int = 0                # >0: chunked fused cross-entropy
    device: str = "auto"             # auto (= cuda) | cuda | cpu
    num_devices: int = 0             # 0 or 1: one device
    mesh_shape: str = "data"         # "data" or "data:1" only

    checkpoint_dir: str | None = None   # refused (queue F item 4)
    checkpoint_every: int = 0
    async_checkpoint: bool = True
    resume: bool = False                # refused (queue F item 4)
    max_restarts: int = 0               # refused (queue F item 5)
    nan_policy: str = "off"             # refused unless off (item 5)
    nan_max_bad: int = 3
    fault_plan: str | None = None       # refused (queue F item 5)
    elastic_width: int = 0              # refused (queue F item 1)
    log_every: int = 20
    metrics_jsonl: str | None = None    # refused (queue F item 6)
    sample_tokens: int = 0              # refused unless 0 (item 7)
    sample_temperature: float = 0.0
    sample_top_k: int = 0
    sample_top_p: float = 0.0
    sample_speculative_k: int = 0
    decode_cache_dtype: str = "float32"
    decode_weights_dtype: str = "float32"


LM_ATTN_IMPLS = ("auto", "flash", "oracle")

# (field, value that means "off", ROADMAP queue F item, what it is)
_LM_REFUSED = (
    ("fsdp", False, 1, "FSDP"),
    ("elastic_width", 0, 1, "elastic width"),
    ("moe_experts", 0, 2, "MoE"),
    ("moe_dispatch_chunk", 0, 2, "chunked MoE dispatch"),
    ("moe_dispatch_dtype", None, 2, "the MoE dispatch dtype"),
    ("grad_accum", 1, 3, "gradient accumulation"),
    ("checkpoint_dir", None, 4, "checkpointing"),
    ("resume", False, 4, "checkpoint resume"),
    ("nan_policy", "off", 5, "the NaN guard"),
    ("fault_plan", None, 5, "fault plans"),
    ("max_restarts", 0, 5, "the crash supervisor"),
    ("metrics_jsonl", None, 6, "the JSONL metrics sink"),
    ("sample_tokens", 0, 7, "sampling after training (generate)"),
)


def check_lm_supported(cfg: LMConfig) -> None:
    """Raise NotImplementedError for a feature of the reference's LM
    trainer that this port does not have yet (ROADMAP queue F)."""
    if cfg.num_devices > 1 or cfg.mesh_shape not in ("data", "data:1"):
        raise NotImplementedError(
            f"num_devices={cfg.num_devices}, mesh_shape={cfg.mesh_shape!r}: "
            "only one device is ported (data parallelism and the other "
            "meshes are ROADMAP queue F item 1)")
    for name, off, item, what in _LM_REFUSED:
        if getattr(cfg, name) != off:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={getattr(cfg, name)!r}: {what} is not ported yet "
                f"(ROADMAP queue F item {item})")
    if cfg.attn_impl not in LM_ATTN_IMPLS:
        raise NotImplementedError(
            f"--attn-impl={cfg.attn_impl!r}: only {'|'.join(LM_ATTN_IMPLS)} "
            "are ported; ring and Ulysses attention are ROADMAP queue F "
            "item 8")


def _add_flag(p: argparse.ArgumentParser, name: str, default,
              choices=None) -> None:
    flag = "--" + name.replace("_", "-")
    if isinstance(default, bool):
        p.add_argument(flag, action=argparse.BooleanOptionalAction,
                       default=default)
        return
    p.add_argument(flag, type=str if default is None else type(default),
                   default=default, choices=choices)


def build_lm_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch lm",
        description="Train the transformer LM on one CUDA device (the "
                    "PyTorch port of mpi_cuda_cnn_tpu's lm command).",
    )
    defaults = LMConfig()
    for f in dataclasses.fields(LMConfig):
        _add_flag(p, f.name, getattr(defaults, f.name),
                  choices=(("off", "abort", "skip", "restore")
                           if f.name == "nan_policy" else None))
    return p


def parse_lm_args(argv: list[str] | None = None) -> LMConfig:
    return LMConfig(**vars(build_lm_parser().parse_args(argv)))


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

"""Config and flags of the CNN `train` and the LM `lm` commands
(counterpart of the reference's `utils/config.py`).

The reference has no flag system: 4 positional IDX paths (cnn.c:408-412)
and every hyperparameter compiled in (rate=0.1 cnn.c:446, nepoch=10
cnn.c:448, batch_size=32 cnn.c:449, seed 0 cnn.c:413). This module keeps
the 4-positional-path form (exit 100 on a wrong count) while exposing
those as flags, with the JAX package's names and defaults.
`--use-kernels` takes the place of `--use-pallas`: the hand-written CUDA
kernels instead of PyTorch's own ops (off by default, as there).

Every feature of both reference trainers is ported, one rank per
device. The CNN's meshes: the data axis (`--num-devices N`,
`--mesh-shape data:N`, `parallel/dp.py`), the model axis of tensor
parallelism and `--fsdp` (`parallel/tp.py`, `parallel/fsdp.py`), and the
pipe axis of pipeline parallelism with `--num-microbatches`
(`parallel/pp.py`). The LM's: the data axis, the seq axis of sequence
parallelism (`--attn-impl auto|flash|oracle|ring|ring_flash|ulysses`,
`parallel/sp.py`), the model axis (`parallel/tp.py`, `parallel/tp_sp.py`),
the pipe axis (`parallel/pp_lm.py`, `parallel/tp_pp_lm.py`), the expert
axis (`parallel/ep.py`) and `--fsdp`, as the reference composes them
(`check_lm_supported`). In both, an axis of another name holds replicas
of the data-parallel step, as in the reference's trainers. Checkpoints,
fault plans, the NaN guard and the supervisor are ported
(`train/checkpoint.py`, `faults.py`); as in
the reference, `--nan-policy` and `--fault-plan` are checked when the
flags are parsed (exit 2), the plan against the command's hook sites.
So are gradient accumulation, rematerialization, bf16 params,
augmentation, the elastic width, the JSONL sink and profiler traces;
`check_train_flags` and `check_elastic_and_accum` refuse, with
ValueError (exit 2), the combinations the reference's trainers refuse.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..faults import fault_plan_arg


# The reference's --device names -> the port's: its accelerator is the
# card here, and the C driver's "jax-cpu" pins the CPU.
_REFERENCE_DEVICES = {"tpu": "cuda", "jax-cpu": "cpu"}


def port_device(name: str) -> str:
    """A device name of either package's configs as the port's: "tpu" ->
    "cuda", "jax-cpu" -> "cpu"; "auto", "cuda", "cuda:N" and "cpu" as
    they are. ValueError on anything else (no name falls back to the
    CPU; a card that is not there raises when the trainer resolves
    it)."""
    name = _REFERENCE_DEVICES.get(name, name)
    if name in ("auto", "cuda", "cpu") or (
            name.startswith("cuda:") and name[5:].isdigit()):
        return name
    raise ValueError(f"unknown device {name!r} (want auto|cuda|cpu, or "
                     "the reference's tpu|jax-cpu)")


class _JsonConfig:
    """The JSON round trip of both config families, the wire format of
    the reference's C ABI (native/tpu_abi.h): `from_json` reads the JSON
    the reference's `from_json` reads. Its field names that the port
    spells differently are renamed (`_RENAMED`), the ones that have no
    meaning here are accepted and dropped (`_INERT`), and its device
    names are mapped (`port_device`)."""

    _RENAMED: dict = {}
    _INERT: tuple = ()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str):
        raw = json.loads(text)
        for old, new in cls._RENAMED.items():
            if old in raw:
                if new in raw:
                    raise ValueError(f"config names both {old!r} and {new!r}")
                raw[new] = raw.pop(old)
        for key in cls._INERT:
            raw.pop(key, None)
        if "device" in raw:
            raw["device"] = port_device(raw["device"])
        return cls(**raw)


@dataclasses.dataclass
class Config(_JsonConfig):
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
    augment: str = "none"         # none | shift | shift-flip
                                  # (data/augment.py)
    aug_pad: int = 2              # max +/- pixels of the random shift

    # Numerics: params held in float32 or bfloat16; compute in either.
    param_dtype: str = "float32"  # float32 | bfloat16
    compute_dtype: str = "float32"  # float32 | bfloat16

    # Execution.
    device: str = "auto"          # auto (= cuda) | cuda | cpu
    num_devices: int = 0          # 0 = all visible (1 on the CPU); N = DP
    mesh_shape: str = "data"      # named axes: "data:4", "data:2,model:2",
                                  # "pipe:2", "pipe:2,data:2", ...
    num_microbatches: int = 0     # pipeline microbatches per step; 0 =
                                  # the pipe-axis size (PP only)
    fsdp: bool = False            # shard params and optimizer state over
                                  # the data axis (parallel/fsdp.py)
    use_kernels: bool = False     # hand-written CUDA kernels (ops/kernel_ops)
    remat: bool = False           # torch.utils.checkpoint per layer
    grad_accum: int = 1           # micro-batches accumulated per step
    scan: bool = True             # device-resident epochs: the uint8 set
                                  # staged on the device once; off = the
                                  # host normalizes and sends each batch
    scan_max_bytes: int = 2 << 30  # larger datasets stream per batch

    # Checkpoints and robustness (train/checkpoint.py, faults.py).
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0     # epochs; 0 = only at the end
    checkpoint_every_steps: int = 0  # steps; > 0 = mid-epoch saves too
    async_checkpoint: bool = True  # write on a background worker
    resume: bool = False
    max_restarts: int = 0         # > 0: restart a crashed run from the
                                  # latest checkpoint (needs the dir)
    nan_policy: str = "off"       # off | abort | skip | restore
    nan_max_bad: int = 3          # bad steps in a row before restore
                                  # rolls back
    fault_plan: str | None = None  # faults.parse_plan, e.g.
                                  # crash@train.step:6

    # Elasticity and observability.
    elastic_width: int = 0        # >0: the width-invariant reduction over
                                  # W0 canonical micro-batches
                                  # (parallel/elastic.py)
    log_every: int = 100          # steps; <= 0 = no logging inside an epoch
    profile_dir: str | None = None  # a torch.profiler trace of train()
    metrics_jsonl: str | None = None  # schema-stamped JSONL records
    eval_every: int = 1           # epochs

    # The reference's `use_pallas` is `use_kernels` here; its `donate`
    # (XLA buffer donation) has no meaning: the update is in place.
    _RENAMED = {"use_pallas": "use_kernels"}
    _INERT = ("donate",)


# --compute-dtype of both trainers -> the dtype the forward casts to
# (None: float32, no cast).
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# --param-dtype of the CNN trainer -> the dtype its params are held in.
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

def parse_mesh_shape(spec: str, total_devices: int) -> dict[str, int]:
    """Parse "data" / "data:4" / "data:4,model:2" into an axis dict.

    A bare axis name takes all remaining devices. The product must divide
    total_devices."""
    axes: dict[str, int] = {}
    free_axis = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, n = part.split(":")
            axes[name.strip()] = int(n)
        else:
            if free_axis is not None:
                raise ValueError(f"mesh spec {spec!r}: only one unsized axis "
                                 "allowed")
            free_axis = part
            axes[part] = -1
    fixed = 1
    for n in axes.values():
        if n > 0:
            fixed *= n
    if free_axis is not None:
        if total_devices % fixed:
            raise ValueError(f"mesh spec {spec!r} does not divide "
                             f"{total_devices} devices")
        axes[free_axis] = total_devices // fixed
    return axes


def data_axes(num_devices: int, mesh_shape: str, visible: int = 1,
              queue: str = "E",
              ported: tuple[str, ...] | None = ("data",)) -> dict[str, int]:
    """The mesh of `--num-devices` (0: the `visible` devices) and
    `--mesh-shape`: {"data": N} and the other `ported` axes it names, in
    its order ("data" first, of size 1, when it names none). `ported`
    None takes any axis and adds no data axis: the mesh is the spec's,
    as the reference's trainer builds it. Raises NotImplementedError
    naming ROADMAP queue `queue` item 1 for an axis not `ported`,
    ValueError for a bad spec."""
    if num_devices < 0:
        raise ValueError(f"--num-devices {num_devices}: want >= 0")
    axes = parse_mesh_shape(mesh_shape, num_devices or visible)
    if ported is None:
        if min(axes.values(), default=0) < 1:
            raise ValueError(f"mesh_shape={mesh_shape!r}: every axis needs "
                             "a size >= 1")
        return axes
    if not set(axes) <= set(ported) or min(axes.values(), default=0) < 1:
        raise NotImplementedError(
            f"mesh_shape={mesh_shape!r}: only the {' and '.join(ported)} "
            f"ax{'es are' if len(ported) > 1 else 'is'} ported (the other "
            f"meshes and FSDP are ROADMAP queue {queue} item 1)")
    return axes if "data" in axes else {"data": 1, **axes}


def cnn_axes(cfg: Config, visible: int = 1) -> dict[str, int]:
    """The CNN trainer's mesh: the axes of `--mesh-shape` as named, over
    `--num-devices` (0: the `visible` devices)."""
    return data_axes(cfg.num_devices, cfg.mesh_shape, visible, ported=None)


def check_batch_divides(batch_size: int, n_data: int) -> None:
    """The JAX trainer's check: every rank takes batch / n_data rows."""
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"data-axis size {n_data}")


def check_elastic_and_accum(elastic_width: int, grad_accum: int,
                            batch_size: int, n_data: int) -> None:
    """The reference trainers' checks of --grad-accum and --elastic-width
    on a data axis of n_data ranks, as ValueErrors: the per-rank batch
    must divide into the micro-batches, the two flags exclude each other,
    and the elastic width obeys `parallel.elastic.check_elastic_width`."""
    if grad_accum > 1 and (batch_size // n_data) % grad_accum:
        raise ValueError(f"per-device batch {batch_size // n_data} not "
                         f"divisible by grad_accum {grad_accum}")
    if elastic_width:
        from ..parallel.elastic import check_elastic_width

        if grad_accum > 1:
            raise ValueError(
                "--elastic-width already scans canonical microbatches; "
                "--grad-accum is redundant with it — drop one of the two")
        check_elastic_width(elastic_width, batch_size, n_data)


def check_train_flags(cfg: Config, axes: dict[str, int]) -> None:
    """The CNN trainer's checks of its flags on a mesh of `axes`, as
    ValueErrors (the reference's `Trainer.__init__` raises the same,
    word for word): the dtypes, the augmentation, --grad-accum and
    --elastic-width, and what the sharded meshes refuse (the elastic
    width on any of them; on the pipe axis --num-microbatches without
    it, --grad-accum, bf16 params, FSDP without a data axis and a batch
    that the microbatches times the data axis do not divide). bf16
    params with float32 compute run on the kernels only (the reference's
    Pallas path computes in float32 against the upcast weights; its XLA
    path raises a dtype error)."""
    n_data = axes.get("data", 1)
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"--compute-dtype={cfg.compute_dtype!r}: want one "
                         f"of {'|'.join(COMPUTE_DTYPES)}")
    if cfg.param_dtype not in PARAM_DTYPES:
        raise ValueError(f"--param-dtype={cfg.param_dtype!r}: want one "
                         f"of {'|'.join(PARAM_DTYPES)}")
    from ..data.augment import make_augment

    make_augment(cfg.augment, pad=cfg.aug_pad)
    n_pipe = axes.get("pipe", 1)
    if cfg.elastic_width and (axes.get("model", 1) > 1 or n_pipe > 1
                              or cfg.fsdp):
        raise ValueError(
            "--elastic-width needs a pure data-parallel mesh "
            f"(mesh_shape={cfg.mesh_shape!r}/--fsdp shard params; "
            "cross-width bitwise resume is only defined for replicated "
            "state)")
    check_elastic_and_accum(cfg.elastic_width, cfg.grad_accum,
                            cfg.batch_size, n_data)
    if n_pipe == 1 and cfg.num_microbatches:
        raise ValueError("--num-microbatches requires a 'pipe' mesh axis "
                         f"(mesh_shape={cfg.mesh_shape!r} has none)")
    if n_pipe > 1:
        if cfg.grad_accum > 1:
            raise ValueError(
                "--grad-accum is redundant on the pipeline path: "
                "--num-microbatches already accumulates over micro-batches")
        if cfg.param_dtype != "float32":
            raise ValueError(
                "pipeline parallelism keeps master params in the packed "
                "f32 stage buffers; use --compute-dtype for low-precision "
                f"compute (got param_dtype={cfg.param_dtype})")
        if cfg.fsdp and n_data <= 1:
            raise ValueError(
                "FSDP x PP shards the packed stage rows over 'data'; add a "
                f"data axis of size > 1 (mesh_shape={cfg.mesh_shape!r})")
        m = cfg.num_microbatches or n_pipe
        if cfg.batch_size % (m * n_data):
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by "
                f"num_microbatches x data-axis ({m} x {n_data})")
    if cfg.param_dtype != "float32":
        if cfg.compute_dtype == "float32" and not cfg.use_kernels:
            raise ValueError(
                f"--param-dtype={cfg.param_dtype} with float32 compute "
                "runs on the kernels only (--use-kernels): PyTorch's conv, "
                "as the reference's XLA conv, wants one dtype for input "
                "and weights; add --use-kernels or --compute-dtype "
                f"{cfg.param_dtype}")


def check_supported(cfg: Config) -> dict[str, int]:
    """The CNN trainer's checks before it builds (every feature of the
    reference's CNN trainer is ported): ValueError for a bad mesh, a
    batch that the data axis does not divide or a flag that
    `check_train_flags` refuses. Returns the mesh's axes (`cnn_axes`)."""
    axes = cnn_axes(cfg)
    check_batch_divides(cfg.batch_size, axes.get("data", 1))
    check_train_flags(cfg, axes)
    return axes


@dataclasses.dataclass
class LMConfig(_JsonConfig):
    """Config of the `lm` command (train/lm_trainer.py): the reference's
    `LMConfig` fields, names and defaults."""

    corpus: str = "self"          # self | synthetic | path to a text file
    dim: int = 256
    depth: int = 4
    heads: int = 8
    kv_heads: int = 0             # 0 = heads (MHA); < heads = GQA
    pos: str = "learned"          # learned | rope
    seq_len: int = 256
    moe_experts: int = 0          # 0 = dense MLP; > 0 = MoE blocks
    moe_top_k: int = 1            # experts per token (1 Switch, 2 GShard)
    moe_dispatch_chunk: int = 0   # > 0: route tokens in chunks of this many
    moe_dispatch_dtype: str | None = None  # bfloat16 | float32 dispatch
    steps: int = 200
    batch_size: int = 8
    lr: float = 3e-4
    lr_schedule: str = "cosine"
    warmup_steps: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 0.0        # global-norm clip; 0 disables
    grad_accum: int = 1           # micro-batches accumulated per step
    seed: int = 0
    donate: bool = True           # no-op here: the update is in place

    compute_dtype: str = "float32"   # float32 | bfloat16
    attn_impl: str = "auto"          # auto | flash | oracle; with a seq
                                     # axis also ring | ring_flash | ulysses
    remat: bool = False
    fsdp: bool = False               # shard params + optimizer state
                                     # over 'data' (parallel/fsdp.py)
    ce_chunk: int = 0                # >0: chunked fused cross-entropy
    device: str = "auto"             # auto (= cuda) | cuda | cpu
    num_devices: int = 0             # 0 = all visible (1 on the CPU)
    mesh_shape: str = "data"         # axes data, seq, model, pipe and
                                     # expert: "data:N", "data:2,model:2",
                                     # "pipe:2,model:2,seq:2", ...

    checkpoint_dir: str | None = None
    checkpoint_every: int = 0           # steps; 0 = only at the end
    async_checkpoint: bool = True
    resume: bool = False
    max_restarts: int = 0
    nan_policy: str = "off"             # off | abort | skip | restore
    nan_max_bad: int = 3
    fault_plan: str | None = None       # faults.parse_plan
    elastic_width: int = 0              # >0: the width-invariant step
    log_every: int = 20
    metrics_jsonl: str | None = None    # schema-stamped JSONL records
    sample_tokens: int = 0              # > 0: generate after training
    sample_temperature: float = 0.0
    sample_top_k: int = 0
    sample_top_p: float = 0.0
    sample_speculative_k: int = 0
    decode_cache_dtype: str = "float32"
    decode_weights_dtype: str = "float32"


LM_MESH_AXES = ("data", "seq", "model", "pipe", "expert")


def lm_axes(cfg: LMConfig) -> dict[str, int]:
    """The LM's mesh: the axes of `--mesh-shape` as named (an axis of
    another name holds replicas, as in the reference's trainer), "data"
    first, of size 1, when it names none."""
    axes = data_axes(cfg.num_devices, cfg.mesh_shape, ported=None)
    return axes if "data" in axes else {"data": 1, **axes}


def _check_lm_mesh(cfg: LMConfig, n: dict[str, int]) -> None:
    """The reference trainer's checks of the mesh and the flags that ride
    it (`train/lm_trainer.py` :225-349), in its order and words."""
    n_data, n_seq, n_model, n_pipe, n_expert = (
        n.get(a, 1) for a in ("data", "seq", "model", "pipe", "expert"))
    if n_expert > 1 and (n_seq > 1 or n_model > 1 or n_pipe > 1
                         or cfg.fsdp):
        raise ValueError(
            "an 'expert' mesh axis composes with 'data' only (EP x DP, "
            "parallel/ep.py make_ep_lm_train_step); MoE under a 'seq' axis "
            "rides EP x SP instead — drop the other axes/--fsdp or the "
            "expert axis")
    if cfg.batch_size % (n_data * n_expert):
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by data x expert "
            f"shards ({n_data} x {n_expert})")
    if cfg.moe_dispatch_chunk and (n_expert > 1 or n_seq > 1 or n_model > 1
                                   or n_pipe > 1):
        raise ValueError(
            "--moe-dispatch-chunk is the SINGLE-DEVICE (or pure-DP) "
            "quadratic-dispatch lever; expert/seq/model/pipe meshes already "
            "shard the routed tokens — drop one of the two")
    if cfg.moe_dispatch_chunk and not cfg.moe_experts:
        raise ValueError(
            "--moe-dispatch-chunk needs an MoE model (--moe-experts)")
    if cfg.moe_dispatch_dtype:
        if not cfg.moe_experts:
            raise ValueError(
                "--moe-dispatch-dtype needs an MoE model (--moe-experts)")
        if cfg.moe_dispatch_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"--moe-dispatch-dtype {cfg.moe_dispatch_dtype!r} must be "
                "'bfloat16' or 'float32'")
        if n_expert > 1 or n_seq > 1 or n_pipe > 1:
            raise ValueError(
                "--moe-dispatch-dtype rides the plain jitted step "
                "(data/model/FSDP meshes); the expert/seq/pipe shard_map "
                "steps don't thread it — drop one of the two (bf16 compute "
                "already gives bf16 dispatch there)")
    if n_model > 1 and n_seq > 1:
        if cfg.fsdp:
            raise ValueError(
                "--fsdp does not compose with the TP x SP shard_map step; "
                "drop it or use data:N,model:M")
        allowed = ("auto", "oracle", "ring", "ring_flash", "flash")
        if n_pipe == 1:
            allowed += ("ulysses",)
        if cfg.attn_impl not in allowed:
            raise ValueError(
                f"--attn-impl {cfg.attn_impl!r} is not wired into this mesh "
                "(TP x SP runs ring/ring_flash/ulysses on the local heads; "
                "with a 'pipe' axis, ring/ring_flash only); use auto")
    if n_pipe > 1 and cfg.fsdp:
        raise ValueError(
            "the LM's 'pipe' axis composes with 'data', 'model', and 'seq' "
            "(up to the full 4D pipe x model x seq x data mesh; "
            "parallel/pp_lm.py, tp_pp_lm.py) but not with --fsdp; drop the "
            "flag or the pipe axis")
    if n_pipe > 1 and cfg.batch_size % (n_pipe * n_data):
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by num_microbatches "
            f"x data-axis ({n_pipe} x {n_data})")
    if n_pipe > 1 and n_seq == 1 and \
            cfg.attn_impl not in ("auto", "oracle", "flash"):
        raise ValueError(
            f"--attn-impl {cfg.attn_impl!r} needs a 'seq' mesh axis (ring "
            "attention shards positions); the pipelined stages see the full "
            "sequence — use auto, flash, or oracle")
    check_batch_divides(cfg.batch_size, n_data)
    if cfg.grad_accum > 1:
        if n_pipe > 1 or (n_seq > 1 and n_model > 1):
            raise ValueError(
                "--grad-accum is not wired into this mesh: the 'pipe' axis "
                "already accumulates over --num-microbatches, and the TP x "
                "SP step doesn't chunk — drop the flag or those axes (plain/"
                "TP/FSDP/SP/EP meshes all accept it)")
        per_shard = cfg.batch_size // (n_data * n_expert)
        if per_shard % cfg.grad_accum:
            raise ValueError(f"per-shard batch {per_shard} not divisible by "
                             f"grad_accum {cfg.grad_accum}")
    if cfg.seq_len % n_seq:
        raise ValueError(f"seq_len {cfg.seq_len} not divisible by seq-axis "
                         f"size {n_seq}")
    if cfg.fsdp and n_data <= 1:
        raise ValueError("--fsdp needs a 'data' mesh axis of size > 1 "
                         f"(mesh_shape={cfg.mesh_shape!r})")
    if cfg.elastic_width:
        from ..parallel.elastic import check_elastic_width

        if n_seq > 1 or n_model > 1 or n_pipe > 1 or n_expert > 1 \
                or cfg.fsdp:
            raise ValueError(
                "--elastic-width needs a pure data-parallel mesh "
                f"(mesh_shape={cfg.mesh_shape!r}/--fsdp shard the state; "
                "cross-width bitwise resume is only defined for replicated "
                "params)")
        if cfg.grad_accum > 1:
            raise ValueError(
                "--elastic-width already scans canonical microbatches; "
                "--grad-accum is redundant with it")
        if cfg.moe_dispatch_chunk or cfg.moe_dispatch_dtype:
            raise ValueError(
                "--moe-dispatch-chunk/--moe-dispatch-dtype ride the plain "
                "jitted step; the elastic shard_map step does not thread "
                "them — drop one of the two")
        check_elastic_width(cfg.elastic_width, cfg.batch_size, n_data)


def _check_lm_layout(cfg: LMConfig, n: dict[str, int]) -> None:
    """The checks the reference makes as it builds a sharded state or
    step (`_check_pp_lm`, `_check_tp_sp`, the TP x SP Ulysses rule, the
    expert axis' need of an MoE model), in its words."""
    n_seq, n_model, n_pipe, n_expert = (
        n.get(a, 1) for a in ("seq", "model", "pipe", "expert"))
    if n_pipe > 1 and cfg.depth % n_pipe:
        raise ValueError(f"depth {cfg.depth} not divisible by pipe-axis "
                         f"size {n_pipe}")
    if n_model > 1 and (n_seq > 1 or n_pipe > 1):
        kv = cfg.kv_heads or cfg.heads
        if cfg.heads % n_model or kv % n_model:
            raise ValueError(
                f"the model-axis size {n_model} must divide both heads "
                f"{cfg.heads} and kv_heads {kv}")
        if (4 * cfg.dim) % n_model:
            raise ValueError(f"MLP hidden {4 * cfg.dim} not divisible by "
                             f"model-axis size {n_model}")
        if n_seq > 1 and n_pipe == 1 and cfg.attn_impl == "ulysses" and \
                (cfg.heads // n_model) % n_seq:
            raise ValueError(
                f"impl='ulysses' under TP x SP needs the TP-local heads "
                f"({cfg.heads}/{n_model} = {cfg.heads // n_model}) divisible "
                f"by the seq-axis size {n_seq}; use ring")
    if n_expert > 1:
        if not cfg.moe_experts:
            raise ValueError(
                "an 'expert' mesh axis needs an MoE model (--moe-experts); "
                "for dense models the axis is just data parallelism — use a "
                "'data' axis")
        if cfg.moe_experts % n_expert:
            raise ValueError(f"experts {cfg.moe_experts} not divisible by "
                             f"expert-axis size {n_expert}")


def check_lm_supported(cfg: LMConfig) -> dict[str, int]:
    """The reference LM trainer's checks of its mesh and flags, as
    ValueErrors in its words (every mesh and flag of its trainer is
    ported): the axes' compositions and divisibilities, the flags each
    mesh refuses, and the layout checks its sharded states make. An
    unknown --attn-impl, or a sequence-parallel one without a seq axis,
    is the trainer's ValueError, as there. Returns the mesh's axes."""
    axes = lm_axes(cfg)
    _check_lm_mesh(cfg, axes)
    _check_lm_layout(cfg, axes)
    return axes


NAN_POLICIES = ("off", "abort", "skip", "restore")


def _add_flag(p: argparse.ArgumentParser, name: str, default,
              surface: str) -> None:
    """One flag of a config field. --nan-policy takes one of
    NAN_POLICIES and --fault-plan is parsed and held to the hook sites
    of `surface` ("train" or "train-lm"), so a bad value exits 2."""
    flag = "--" + name.replace("_", "-")
    if isinstance(default, bool):
        p.add_argument(flag, action=argparse.BooleanOptionalAction,
                       default=default)
        return
    ftype = str if default is None else type(default)
    if name == "fault_plan":
        ftype = fault_plan_arg(surface)
    p.add_argument(flag, type=ftype, default=default,
                   choices=NAN_POLICIES if name == "nan_policy" else None)


def build_lm_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch lm",
        description="Train the transformer LM on CUDA devices, data "
                    "parallel with one rank per device (the PyTorch port of "
                    "mpi_cuda_cnn_tpu's lm command).",
    )
    defaults = LMConfig()
    for f in dataclasses.fields(LMConfig):
        _add_flag(p, f.name, getattr(defaults, f.name), "train-lm")
    return p


def parse_lm_args(argv: list[str] | None = None) -> LMConfig:
    return LMConfig(**vars(build_lm_parser().parse_args(argv)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch train",
        description="CNN trainer on CUDA devices, data parallel with one "
                    "rank per device (the PyTorch port of mpi_cuda_cnn_tpu's "
                    "train command).",
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
        _add_flag(p, f.name, getattr(defaults, f.name), "train")
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

"""End-to-end LM trainer: corpus -> trained TransformerLM, on one device
or as one rank of a data mesh (counterpart of the single-device and
data-parallel branches of the reference's `train/lm_trainer.py`).

Char-level corpus, random (seq_len + 1)-windows as batches, a 10%
held-out tail for eval, AdamW with a warm-up + cosine schedule. The
windows of step k come from `np.random.default_rng((seed, k))`, bitwise
the reference's. The trainer is one rank of a data mesh (given none,
the world-1 mesh of its device, `parallel.mesh.device_mesh`, with no
collective): every rank draws the same windows and keeps its rows
(`dp_shard_batch`), the seeded init is broadcast from rank 0, and the
eval runs replicated (every rank holds the same params and windows;
rank 0 reports). Crash safety is the CNN trainer's
(`train/recovery.py`): `checkpoint_dir` saves the state (params, AdamW's
moments and count, the step) every `checkpoint_every` steps and at the
end; `resume` re-enters at the restored step (the windows are a
function of the step, so the resume is step-exact); planned
"train.step" faults fire after every step; the NaN guard checks every
step (token batches carry no NaN, so it meets organic non-finite
losses only); a preemption snapshots and raises `faults.Preempted`.
`grad_accum` accumulates each rank's rows over micro-batches and
`elastic_width` takes the width-invariant reduction (`train/lm.py`,
`parallel/elastic.py`). `moe_experts` trains MoE blocks, the ranks'
tokens routed as one global batch (`parallel/moe.py`), with
`moe_dispatch_chunk` and `moe_dispatch_dtype`; `sample` generates after
training (`models/generate.py`), and the sampling flags are checked at
construction, so that a typo fails before the run. With a JSONL sink
the trainer writes the reference's records: "program" for its first
step, counted as it runs (`obs/cost.py`), "train" and a "metrics"
snapshot at every log step, then "step_phases", "memory", a final
"metrics" and the eval's "span". With a seq axis (`--mesh-shape seq:P`
or `data:N,seq:P`) the step is the sequence-parallel one of
`parallel/sp.py`: each rank takes its (B/N, S/P) block of the windows,
attention is ring, ring-flash or Ulysses (`pick_ring_impl`), and the
eval runs the full sequence on every rank with flash (for ring-flash) or
the oracle, as the reference's does; MoE blocks there run
expert-parallel over 'seq'. With an 'expert' axis the step is EP x DP
(`parallel/ep.py`: the rows over data x expert, the MoE slots
all-to-all'd over 'expert'). On a 'model' or 'pipe' axis, and under
--fsdp, the params are sharded and the step is `parallel/lm_shard.py`'s
(`ShardedLM`: tensor parallelism with the Megatron block, FSDP, FSDP x
TP, FSDP x SP, TP x SP, GPipe with data, seq and model up to the 4D
mesh), the clip in the step with the norm over the world, checkpoints
in the reference's tree of the mesh (`Recovery`'s codec), and the eval
and the sample on a mesh without a model axis from the whole standard
tree, gathered on every rank; with one, every rank of the model line
decodes from its shards (`parallel/tp_decode.py`).
The reference's checks of the mesh and its flags are
`utils.config.check_lm_supported`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..faults import PreemptionGuard, RollbackToCheckpoint
from ..models.transformer import TransformerLM
from ..obs.cost import ProgramLog
from ..obs.device import emit_step_telemetry
from ..obs.metrics import MetricsRegistry
from ..obs.trace import span
from ..models.layers import tree_leaves
from ..parallel.dp import dp_shard_batch, replicate
from ..parallel.moe import check_dispatch_chunk
from ..parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    device_mesh,
)
from ..parallel.sp import make_sp_lm_train_step, sp_shard_batch
from ..utils.config import COMPUTE_DTYPES, check_lm_supported
from ..utils.logging import MetricsLogger, get_logger
from ..utils.profiling import StepTimer
from .lm import (
    get_attn_fn,
    lm_loss,
    make_elastic_lm_train_step,
    make_lm_state,
    make_lm_train_step,
    pick_attn_impl,
)
from .optimizer import make_optimizer
from .recovery import Recovery


def pick_ring_impl(impl: str, seq_len: int, n_seq: int,
                   device: torch.device | str) -> str:
    """The sequence-parallel attention of `--attn-impl` on a seq axis of
    n_seq ranks, the reference's rule: "auto" and "flash" take ring-flash
    on a CUDA device when the per-shard sequence is a multiple of 128
    (the kernels take every head dim), else
    the plain ring; "oracle" is the plain ring (exact, as the oracle);
    the others are taken as asked."""
    if impl in ("auto", "flash"):
        flash = (torch.device(device).type == "cuda"
                 and (seq_len // n_seq) % 128 == 0)
        return "ring_flash" if flash else "ring"
    return "ring" if impl == "oracle" else impl


def check_sample_flags(cfg) -> None:
    """The reference trainer's checks of the sampling flags, made at
    construction (a failure after an hours-long run would lose the run's
    purpose), with its words: --sample-tokens in [0, seq_len), the
    decode dtypes, --sample-top-k / --sample-top-p and their need of a
    temperature, --sample-speculative-k >= 2 and its slack."""
    if cfg.sample_tokens < 0 or cfg.sample_tokens >= cfg.seq_len:
        raise ValueError(
            f"--sample-tokens {cfg.sample_tokens} must be in "
            f"[0, seq_len {cfg.seq_len}) — the prompt needs >= 1 "
            f"position of the decode budget")
    if cfg.decode_cache_dtype not in ("float32", "bfloat16", "int8", "auto"):
        raise ValueError(
            f"--decode-cache-dtype {cfg.decode_cache_dtype!r} must "
            "be 'float32', 'bfloat16', 'int8', or 'auto'")
    if cfg.decode_weights_dtype not in ("float32", "bfloat16", "int8",
                                        "auto"):
        raise ValueError(
            f"--decode-weights-dtype {cfg.decode_weights_dtype!r} "
            "must be 'float32', 'bfloat16', 'int8', or 'auto'")
    if cfg.sample_top_k < 0 or not 0.0 <= cfg.sample_top_p <= 1.0:
        raise ValueError(
            f"--sample-top-k {cfg.sample_top_k} must be >= 0 and "
            f"--sample-top-p {cfg.sample_top_p} in [0, 1]")
    if (cfg.sample_top_k or cfg.sample_top_p) and cfg.sample_temperature <= 0:
        raise ValueError(
            "--sample-top-k/--sample-top-p restrict SAMPLING — set "
            "--sample-temperature > 0 (greedy already takes the "
            "single most likely token)")
    if cfg.sample_speculative_k:
        if cfg.sample_speculative_k < 2:
            raise ValueError(
                f"--sample-speculative-k {cfg.sample_speculative_k} "
                "must be >= 2 (the verify block needs proposals)")
        if cfg.sample_tokens and cfg.sample_tokens + \
                cfg.sample_speculative_k + 2 > cfg.seq_len:
            raise ValueError(
                f"--sample-tokens {cfg.sample_tokens} + speculative "
                f"slack k={cfg.sample_speculative_k} + a >= 2-token "
                f"prompt exceeds seq_len {cfg.seq_len}")


def load_corpus(spec: str, package_root: Path | None = None) -> np.ndarray:
    """A corpus spec as a char-level int32 token array.

    "self"      this package's own Python sources (real text, no network).
                They are the port's sources, so the stream and its vocab
                differ from the reference's "self", which reads the JAX
                package's.
    "synthetic" cyclic-successor tokens (deterministic, converges fast).
    a path      any local text or bytes file.
    """
    if spec == "synthetic":
        return (np.arange(1 << 20) % 251).astype(np.int32)
    if spec == "self":
        root = package_root or Path(__file__).resolve().parents[1]
        data = b"\n".join(p.read_bytes() for p in sorted(root.rglob("*.py")))
    else:
        data = Path(spec).read_bytes()
    if len(data) < 1 << 12:
        raise ValueError(f"corpus {spec!r} too small: {len(data)} bytes")
    return np.frombuffer(data, np.uint8).astype(np.int32)


@dataclasses.dataclass
class LMResult:
    steps_run: int
    final_loss: float
    eval_loss: float
    eval_ppl: float
    tokens_per_s: float


class LMTrainer:
    """tokens (an int32 stream) + config -> trained params, as one rank of
    the data mesh `mesh` (on `mesh.device`), or on cfg.device alone.

    `params` (a params tree, e.g. `convert.params_from_jax` of the
    reference's initial params) replaces the seeded init. `faults` and
    `preempt` are as the CNN `Trainer`'s.
    """

    def __init__(self, cfg, *, metrics: MetricsLogger | None = None,
                 params: dict | None = None, mesh=None, faults=None,
                 preempt: PreemptionGuard | None = None, registry=None,
                 clock=None):
        axes = check_lm_supported(cfg)
        if mesh is None and math.prod(axes.values()) > 1:
            raise ValueError(
                f"num_devices={cfg.num_devices}, mesh_shape="
                f"{cfg.mesh_shape!r}: an LMTrainer is one rank; pass the "
                "rank's mesh (parallel.make_mesh under parallel.run_ranks "
                "or torchrun), or run the lm command")
        self.cfg = cfg
        self.log = get_logger()
        self.metrics = metrics or MetricsLogger()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._clock = clock if clock is not None else time.perf_counter
        self.device = resolve_device(cfg.device if mesh is None
                                     else mesh.device)
        self.mesh = mesh = mesh or device_mesh(self.device)
        n_data = mesh.shape.get(DATA_AXIS, 1)
        self.n_seq = n_seq = mesh.shape.get(SEQ_AXIS, 1)
        self.n_model = mesh.shape.get(MODEL_AXIS, 1)
        self.n_pipe = mesh.shape.get(PIPE_AXIS, 1)
        self.n_expert = mesh.shape.get(EXPERT_AXIS, 1)

        tokens = load_corpus(cfg.corpus)
        vocab = int(tokens.max()) + 1
        split = max(len(tokens) - len(tokens) // 10, cfg.seq_len + 1)
        self.train_tokens = tokens[:split]
        self.eval_tokens = tokens[split:]
        if len(self.train_tokens) < cfg.seq_len + 1:
            raise ValueError(f"corpus ({len(tokens)} tokens) shorter than "
                             f"--seq-len {cfg.seq_len}")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"--compute-dtype {cfg.compute_dtype!r}: "
                             f"{' or '.join(COMPUTE_DTYPES)}")
        if cfg.ce_chunk and (cfg.seq_len // n_seq) % cfg.ce_chunk:
            raise ValueError(
                f"--ce-chunk {cfg.ce_chunk} must divide the per-shard "
                f"sequence {cfg.seq_len // n_seq} (seq_len {cfg.seq_len} "
                f"over seq:{n_seq})" if n_seq > 1 else
                f"--ce-chunk {cfg.ce_chunk} must divide the sequence "
                f"{cfg.seq_len}")
        check_sample_flags(cfg)

        self.model = TransformerLM(
            vocab=vocab, dim=cfg.dim, heads=cfg.heads, depth=cfg.depth,
            max_seq=cfg.seq_len, moe_experts=cfg.moe_experts,
            moe_top_k=cfg.moe_top_k, kv_heads=cfg.kv_heads, pos=cfg.pos)

        # Cosine needs positive decay steps: clamp the warm-up only when it
        # would swallow the whole (short) run, and say so.
        warmup = cfg.warmup_steps
        if warmup >= cfg.steps:
            warmup = max(cfg.steps - 1, 0)
            self.log.warning("warmup_steps %d >= steps %d; clamped to %d",
                             cfg.warmup_steps, cfg.steps, warmup)
        self.warmup_steps = warmup
        # The sharded meshes clip in their step, with the norm over the
        # world. The optimizer's chain is the reference's all the same
        # (its checkpoint names follow it): its pipelined, TP x SP and
        # FSDP x SP steps clip in-step and hold no clip in the chain; on
        # its GSPMD meshes optax clips the global gradient, whose norm
        # the in-step clip takes here.
        sharded = (self.n_pipe > 1 or self.n_model > 1
                   or (cfg.fsdp and n_data > 1))
        clip_in_step = self.n_pipe > 1 or n_seq > 1 and (
            self.n_model > 1 or cfg.fsdp)
        self.optimizer = make_optimizer(
            cfg.lr, opt="adamw", schedule=cfg.lr_schedule,
            total_steps=cfg.steps or None, warmup_steps=warmup,
            weight_decay=cfg.weight_decay,
            grad_clip=0.0 if clip_in_step else cfg.grad_clip)
        self._compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        if n_seq > 1:
            self.attn_impl = pick_ring_impl(cfg.attn_impl, cfg.seq_len,
                                            n_seq, self.device)
        else:
            self.attn_impl = pick_attn_impl(cfg.attn_impl, cfg.seq_len,
                                            self.device)
        if cfg.moe_dispatch_chunk and n_data > 1 and not cfg.elastic_width:
            # The ranks route each micro-batch as one global batch; a chunk
            # must divide a rank's tokens or be a whole number of them.
            per_rank = cfg.batch_size // n_data // cfg.grad_accum
            check_dispatch_chunk(per_rank * cfg.seq_len,
                                 cfg.moe_dispatch_chunk, n_data)
        dispatch_dtype = (getattr(torch, cfg.moe_dispatch_dtype)
                          if cfg.moe_dispatch_dtype else None)
        self.par = None
        if sharded:
            from ..parallel.lm_shard import ShardedLM

            self.par = ShardedLM(
                self.model, mesh, attn_impl=self.attn_impl, fsdp=cfg.fsdp,
                compute_dtype=self._compute_dtype, remat=cfg.remat,
                ce_chunk=cfg.ce_chunk, grad_accum=cfg.grad_accum,
                moe_dispatch_dtype=dispatch_dtype)
            self.train_step = self.par.make_train_step(
                self.optimizer, grad_clip=cfg.grad_clip)
        elif self.n_expert > 1:
            from ..parallel.ep import make_ep_lm_train_step

            self.train_step = make_ep_lm_train_step(
                self.model, self.optimizer, mesh, attn_impl=self.attn_impl,
                remat=cfg.remat, compute_dtype=self._compute_dtype,
                ce_chunk=cfg.ce_chunk, grad_accum=cfg.grad_accum)
        elif n_seq > 1:
            self.train_step = make_sp_lm_train_step(
                self.model, self.optimizer, mesh, impl=self.attn_impl,
                data_axis=DATA_AXIS if n_data > 1 else None, remat=cfg.remat,
                compute_dtype=self._compute_dtype, ce_chunk=cfg.ce_chunk,
                grad_accum=cfg.grad_accum)
        elif cfg.elastic_width:
            self.train_step, _ = make_elastic_lm_train_step(
                self.model, self.optimizer, mesh,
                elastic_width=cfg.elastic_width, attn_impl=self.attn_impl,
                seq_len=cfg.seq_len, compute_dtype=self._compute_dtype,
                remat=cfg.remat, ce_chunk=cfg.ce_chunk)
        else:
            self.train_step = make_lm_train_step(
                self.model, self.optimizer, attn_impl=self.attn_impl,
                seq_len=cfg.seq_len, device=self.device,
                compute_dtype=self._compute_dtype, remat=cfg.remat,
                ce_chunk=cfg.ce_chunk, mesh=mesh, grad_accum=cfg.grad_accum,
                moe_dispatch_chunk=cfg.moe_dispatch_chunk,
                moe_dispatch_dtype=dispatch_dtype)
        self.loss_fn = self.train_step.loss_fn
        self.state = make_lm_state(self.model, self.optimizer, cfg.seed,
                                   params=params, device=self.device)
        replicate(self.state["params"], mesh)
        codec = None
        if self.par is not None:
            self.state = self.par.place(self.state["params"], self.optimizer)
            opt = self.optimizer
            codec = (lambda st: self.par.checkpoint_arrays(st, opt),
                     lambda st, arrays: self.par.load_arrays(st, arrays, opt))
        self._standard = None
        self.sample_cache_bytes = 0     # the last sample's cache, this rank
        self.recovery = Recovery(cfg, mesh, self.optimizer,
                                 metrics=self.metrics, logger=self.log,
                                 faults=faults, preempt=preempt, codec=codec)

    # ------------------------------------------------------------------

    def _sample_batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(B, S) inputs and targets: random windows of the train stream,
        from an RNG keyed on (seed, step), so step k sees the same windows
        in any run and on every rank (the reference's step-exact
        contract)."""
        cfg = self.cfg
        n = len(self.train_tokens) - cfg.seq_len
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=cfg.batch_size)
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        w = self.train_tokens[idx]
        return w[:, :-1], w[:, 1:]

    def first_grads(self) -> list[torch.Tensor]:
        """The gradients step 0 applies, at the current params: this
        rank's rows of its windows through the step's gradient path (its
        accumulation or elastic reduction, and the reduction over the
        ranks)."""
        tokens, targets = self._shard(self._sample_batch(0))
        grads, _ = self.train_step.grads(self.state, self._to_device(tokens),
                                         self._to_device(targets))
        if self.par is not None:
            grads = [t.clone() for t in self.par.standard_leaves(grads)]
        return grads

    def full_leaves(self) -> list[torch.Tensor]:
        """The whole params' leaves in the standard tree's order, on every
        rank (on a sharded mesh one all-reduce of the blocks)."""
        return tree_leaves(self.standard_params())

    def standard_params(self) -> dict:
        """The whole params in the standard tree, on every rank: the live
        ones on a data mesh; on a sharded one, put together from the
        blocks (a collective, made once a step: every rank calls it)."""
        if self.par is None:
            return self.state["params"]
        if self._standard is None or self._standard[0] != self.state["step"]:
            self._standard = (self.state["step"],
                              self.par.standard_params(self.state))
        return self._standard[1]

    def _shard(self, batch):
        """This rank's block of a (B, S) batch: its data-axis rows (on a
        pipe axis each microbatch's, in microbatch order; on an expert
        axis its rows of data x expert), and under a seq axis its shard's
        columns."""
        if self.n_pipe > 1:
            from ..parallel.pp_lm import pp_lm_shard_batch

            return tuple(pp_lm_shard_batch(t, self.mesh, self.n_pipe)
                         for t in batch)
        if self.n_expert > 1:
            from ..parallel.ep import ep_shard_batch

            return tuple(ep_shard_batch(t, self.mesh) for t in batch)
        if self.n_seq > 1:
            return sp_shard_batch(batch, self.mesh)
        return dp_shard_batch(batch, self.mesh)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> LMResult:
        """cfg.steps steps (from the latest checkpoint with `resume`),
        then the eval."""
        cfg = self.cfg
        rec = self.recovery
        # A checkpoint past --steps leaves nothing to run.
        start_step = (min(self.state["step"], cfg.steps)
                      if rec.resume(self.state) else 0)
        t0 = self._clock()
        loss = float("nan")
        m = None
        timer = StepTimer(clock=self._clock)
        timer.start()
        reg = self.registry
        programs = ProgramLog(self.metrics, self.device, cfg.compute_dtype)
        last_t, last_step = t0, start_step
        try:
            step = start_step
            while step < cfg.steps:
                with timer.phase("data"):
                    tokens, targets = self._shard(self._sample_batch(step))
                    tokens = self._to_device(tokens)
                    targets = self._to_device(targets)
                snap = rec.snapshot(self.state)
                # the first step with a sink open runs counted and logs
                # its `program` record (obs/cost.py)
                with programs.dispatch("lm_train_step", timer):
                    self.state, m = self.train_step(self.state, tokens,
                                                    targets)
                try:
                    kept = rec.check_step(self.state, m["loss"], step, snap)
                except RollbackToCheckpoint:
                    rec.rollback(self.state)
                    step = self.state["step"]
                    continue
                if kept and cfg.log_every and (step + 1) % cfg.log_every == 0:
                    with timer.phase("device"):
                        loss = float(m["loss"])   # the only host sync
                    self.metrics.log("train", step=step + 1, loss=loss)
                    now = self._clock()
                    n, dt = step + 1 - last_step, now - last_t
                    if n > 0 and dt > 0:
                        reg.inc("train.steps", n)
                        reg.inc("train.heartbeats")
                        reg.observe("train.step_ms", 1e3 * dt / n)
                        reg.set("train.tokens_per_s",
                                n * cfg.batch_size * cfg.seq_len / dt)
                        reg.set("train.loss", loss)
                        reg.emit(self.metrics, step=step + 1)
                    last_t, last_step = now, step + 1
                with timer.phase("checkpoint"):
                    rec.save_every(self.state, cfg.checkpoint_every,
                                   step + 1)
                rec.step_boundary(self.state, step + 1)
                step += 1
            with timer.phase("device"):
                self._sync()
            dt = self._clock() - t0
            rec.finish(self.state)
        finally:
            rec.close()
        steps_run = cfg.steps - start_step
        if m is not None:
            loss = float(m["loss"])
        timer.stop(max(steps_run, 1))
        emit_step_telemetry(self.metrics, timer, steps_run,
                            devices=[self.device])
        tok_s = steps_run * cfg.batch_size * cfg.seq_len / max(dt, 1e-9)
        if steps_run > 0:
            if cfg.steps > last_step:
                reg.inc("train.steps", cfg.steps - last_step)
            reg.set("train.tokens_per_s", tok_s)
            reg.emit(self.metrics, final=True)
        with span("eval", metrics=self.metrics.sink_or_none()):
            eval_loss = self.evaluate()
        ppl = float(np.exp(eval_loss)) if math.isfinite(eval_loss) else eval_loss
        self.log.info(
            "lm done: steps=%d loss=%.4f eval_loss=%.4f ppl=%.2f tok/s=%.0f",
            steps_run, loss, eval_loss, ppl, tok_s)
        return LMResult(steps_run=steps_run, final_loss=loss,
                        eval_loss=eval_loss, eval_ppl=ppl,
                        tokens_per_s=tok_s)

    def eval_windows(self) -> np.ndarray:
        """Up to 8 deterministic (seq_len + 1)-windows of the held-out
        tail (of the train stream for a tiny corpus)."""
        s = self.cfg.seq_len
        stream = self.eval_tokens
        if len(stream) < s + 1:
            stream = self.train_tokens
        nwin = min(8, (len(stream) - 1) // s)
        return np.stack([stream[i * s:i * s + s + 1] for i in range(nwin)]) \
            if nwin else np.zeros((0, s + 1), np.int32)

    @torch.no_grad()
    def evaluate(self) -> float:
        """Mean next-token NLL over the held-out windows in one batched
        forward (equal windows: the batch mean is the mean of the window
        means), with flash attention when training used it (flash or
        ring-flash), else the oracle; the full sequence on every rank, from
        the whole standard params."""
        params = self.standard_params()
        wins = self.eval_windows()
        if not len(wins):
            return float("nan")
        attn_fn = get_attn_fn("flash" if self.attn_impl in ("flash",
                                                            "ring_flash")
                              else "oracle")
        loss = lm_loss(self.model, params,
                       self._to_device(wins[:, :-1]),
                       self._to_device(wins[:, 1:]), attn_fn=attn_fn,
                       compute_dtype=self._compute_dtype, moe_aux_weight=0.0,
                       ce_chunk=self.cfg.ce_chunk)
        return float(loss)

    @torch.no_grad()
    def sample(self, num_tokens: int, *, prompt_len: int | None = None,
               temperature: float = 0.0, seed: int = 0):
        """A continuation of the held-out stream through the KV-cache
        decode path (`models/generate.py`): the prompt from the eval tail,
        greedy by default, with the decode dtypes resolved for this
        model's heads (int8 weights take K2 on the card); with
        --sample-speculative-k, prompt-lookup speculation. On a mesh with
        a model axis every rank of the model line decodes together from
        its shards, with its heads of the cache (`parallel/tp_decode.py`;
        every rank must call this): on the plain model mesh the rank's
        live shards (its FSDP split gathered over the data line), on the
        head-structured and packed layouts (TP x SP, TP x PP) its shards
        sliced from `standard_params`, as the reference re-places the
        params it converts; float32 weights, as the reference's
        model-parallel decode keeps them. On another sharded mesh the
        decode runs from the whole standard params (`standard_params`,
        which every rank must have made at this step: `train()` makes
        them for its eval). Returns (prompt, continuation) as int32 numpy
        arrays."""
        from ..data import prng
        from ..models.generate import (
            decoder,
            generate,
            lookup_speculative_generate,
            pick_cache_dtype,
            pick_weights_dtype,
        )
        from ..ops.gemv import quantize_decode_params

        cfg = self.cfg
        # The verify block needs k positions of cache slack beyond prompt
        # + num_tokens: shrink the prompt, not k.
        spec_k = cfg.sample_speculative_k
        max_prompt = cfg.seq_len - num_tokens - spec_k
        if max_prompt < (2 if spec_k else 1):
            raise ValueError(
                f"--sample-tokens {num_tokens}"
                + (f" + speculative slack k={spec_k}" if spec_k else "")
                + f" leaves no room for a prompt within seq_len "
                f"{cfg.seq_len}")
        p = min(prompt_len or max(cfg.seq_len // 2, 1), max_prompt)
        stream = (self.eval_tokens if len(self.eval_tokens) >= p
                  else self.train_tokens)
        prompt = self._to_device(np.asarray(stream[:p], np.int64)[None, :])
        model = self.model
        heads = dict(heads=model.heads, kv_heads=model.n_kv)
        wdt = pick_weights_dtype(cfg.decode_weights_dtype, **heads)
        if wdt != "float32" and self.n_model > 1:
            raise ValueError(
                "--decode-weights-dtype requires an unsharded sample path "
                "(model-parallel decode keeps f32 weights; set "
                "--decode-weights-dtype float32)")
        if self.n_model > 1:
            from ..parallel.tp_decode import TPDecoder

            dec = (TPDecoder.from_sharded(self.par, self.state)
                   if self.par.ckpt_form == "standard" else
                   TPDecoder.from_params(model, self.standard_params(),
                                         self.mesh))
        else:
            dec = decoder(model, quantize_decode_params(
                self.standard_params(), wdt))
        cache_dtype = pick_cache_dtype(cfg.decode_cache_dtype, **heads)
        key = prng.key(seed) if temperature > 0 else None
        sampling = dict(temperature=temperature, key=key,
                        cache_dtype=cache_dtype, top_k=cfg.sample_top_k,
                        top_p=cfg.sample_top_p)
        if spec_k:
            if p < 2:
                raise ValueError(
                    f"--sample-speculative-k needs a prompt of >= 2 "
                    f"tokens (resolved prompt length {p}; raise "
                    f"prompt_len or seq_len)")
            toks = lookup_speculative_generate(model, dec, prompt,
                                               num_tokens, k=spec_k,
                                               **sampling)
        else:
            toks = generate(model, dec, prompt, num_tokens, **sampling)
        self.sample_cache_bytes = dec.cache_bytes
        return (np.asarray(stream[:p], np.int32),
                toks[0].cpu().numpy().astype(np.int32))

"""End-to-end LM trainer: corpus -> trained TransformerLM, on one device
(counterpart of the single-device branch of the reference's
`train/lm_trainer.py`).

Char-level corpus, random (seq_len + 1)-windows as batches, a 10%
held-out tail for eval, AdamW with a warm-up + cosine schedule. The
windows of step k come from `np.random.default_rng((seed, k))`, bitwise
the reference's. What the reference's trainer adds around this loop
(meshes, MoE, gradient accumulation, checkpoints, the NaN guard and fault
plans, the JSONL sink, sampling after training) is refused by
`utils.config.check_lm_supported` (ROADMAP queue F).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..models.transformer import TransformerLM
from ..utils.config import COMPUTE_DTYPES, check_lm_supported
from ..utils.logging import MetricsLogger, get_logger
from .lm import (
    get_attn_fn,
    lm_loss,
    make_lm_state,
    make_lm_train_step,
    pick_attn_impl,
)
from .optimizer import make_optimizer


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
    """tokens (an int32 stream) + config -> trained params, on one device.

    `params` (a params tree, e.g. `convert.params_from_jax` of the
    reference's initial params) replaces the seeded init.
    """

    def __init__(self, cfg, *, metrics: MetricsLogger | None = None,
                 params: dict | None = None):
        check_lm_supported(cfg)
        self.cfg = cfg
        self.log = get_logger()
        self.metrics = metrics or MetricsLogger()
        self.device = resolve_device(cfg.device)

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
        if cfg.ce_chunk and cfg.seq_len % cfg.ce_chunk:
            raise ValueError(f"--ce-chunk {cfg.ce_chunk} must divide the "
                             f"sequence {cfg.seq_len}")

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
        self.optimizer = make_optimizer(
            cfg.lr, opt="adamw", schedule=cfg.lr_schedule,
            total_steps=cfg.steps or None, warmup_steps=warmup,
            weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
        self._compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.attn_impl = pick_attn_impl(cfg.attn_impl, cfg.seq_len,
                                        self.device)
        self.train_step = make_lm_train_step(
            self.model, self.optimizer, attn_impl=self.attn_impl,
            seq_len=cfg.seq_len, device=self.device,
            compute_dtype=self._compute_dtype, remat=cfg.remat,
            ce_chunk=cfg.ce_chunk)
        self.state = make_lm_state(self.model, self.optimizer, cfg.seed,
                                   params=params, device=self.device)

    # ------------------------------------------------------------------

    def _sample_batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(B, S) inputs and targets: random windows of the train stream,
        from an RNG keyed on (seed, step), so step k sees the same windows
        in any run (the reference's step-exact contract)."""
        cfg = self.cfg
        n = len(self.train_tokens) - cfg.seq_len
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=cfg.batch_size)
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        w = self.train_tokens[idx]
        return w[:, :-1], w[:, 1:]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> LMResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        loss = float("nan")
        m = None
        for step in range(cfg.steps):
            tokens, targets = self._sample_batch(step)
            self.state, m = self.train_step(self.state,
                                            self._to_device(tokens),
                                            self._to_device(targets))
            if cfg.log_every and (step + 1) % cfg.log_every == 0:
                loss = float(m["loss"])          # the only host sync
                self.metrics.log("train", step=step + 1, loss=loss)
        self._sync()
        dt = time.perf_counter() - t0
        if m is not None:
            loss = float(m["loss"])
        eval_loss = self.evaluate()
        tok_s = cfg.steps * cfg.batch_size * cfg.seq_len / max(dt, 1e-9)
        ppl = float(np.exp(eval_loss)) if math.isfinite(eval_loss) else eval_loss
        self.log.info(
            "lm done: steps=%d loss=%.4f eval_loss=%.4f ppl=%.2f tok/s=%.0f",
            cfg.steps, loss, eval_loss, ppl, tok_s)
        return LMResult(steps_run=cfg.steps, final_loss=loss,
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
        means), with flash attention when training used it."""
        wins = self.eval_windows()
        if not len(wins):
            return float("nan")
        attn_fn = get_attn_fn("flash" if self.attn_impl == "flash"
                              else "oracle")
        loss = lm_loss(self.model, self.state["params"],
                       self._to_device(wins[:, :-1]),
                       self._to_device(wins[:, 1:]), attn_fn=attn_fn,
                       compute_dtype=self._compute_dtype, moe_aux_weight=0.0,
                       ce_chunk=self.cfg.ce_chunk)
        return float(loss)

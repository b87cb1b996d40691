"""What tests/test_torch_lm_{tp,fsdp,pp,tp_sp,tp_pp,ep}.py share: the
JAX `LMTrainer` on conftest's 8 CPU devices as the oracle of the port's
LM meshes.

Each case is a mesh and flags over BASE (dim 32, depth 4, heads 4, seq
64); the MoE cases (4 experts, top-2) at depth 2, the size at which
tests/test_torch_moe.py declares its band: at depth 4 the one-device
trainers of the two packages already move block 0's layernorm biases
1.2e-4 (relative L2) apart in 3 AdamW steps, since a few elements of
their first gradients sit at rounding level and AdamW steps each by lr
times its sign. The JAX trainer takes STEPS steps from its `--seed 0`
init, logging every step, evaluates and checkpoints; the port takes the
same steps on
gloo CPU ranks through `train.ranks.lm_rank_runs` (one spawn of the
ranks for every case of a world size), from the same params
(`convert.params_from_jax` of the JAX init), and also resumes a copy of
the JAX case's checkpoint. Held:

- the first step's gradients per leaf within GRAD_REL relative L2: a
  dense model's against the JAX loss's own gradient of the first batch
  on one device (what every mesh's step differentiates); an MoE model's,
  whose routing depends on the mesh, against the gradient the JAX
  trainer's step on that mesh applies (its optimizer replaced by one
  that keeps the gradient as its state; FSDP, which changes no
  gradient, left out of that run);
- the per-step losses and the eval loss within LOSS_RTOL relative, the
  params after the steps within PARAM_REL per leaf (relative L2, as
  tests/test_torch_sp_trainer.py holds them: AdamW's first update is
  lr times the sign of each gradient, so an element of a gradient at
  rounding level may move either way), an MoE model's in the band of
  tests/test_torch_moe.py (`assert_params`);
- the port's resume of the JAX file, and the JAX trainer's restore of
  the port's file, bit for bit;
- where a case asks (`sample`), the port's greedy tokens after that
  resume equal the JAX trainer's `sample` on its mesh from the same
  params: on a mesh with a model axis on every rank, each decoding from
  its shards with a cache of 1 / n_model of one device's bytes
  (`parallel/tp_decode.py`), on another mesh on rank 0 from the whole
  params.

The JAX package is imported where it runs: a spawned rank imports the
port only.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np

from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank_runs
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig

STEPS = 3
GRAD_REL = 1e-5
PARAM_REL = 1e-5
LOSS_RTOL = 1e-5
MOE_PARAM_ATOL = 1e-6
SAMPLE_TOKENS = 8
BASE = dict(corpus="synthetic", dim=32, depth=4, heads=4, seq_len=64,
            batch_size=8, steps=STEPS, warmup_steps=1, lr=3e-3,
            log_every=1, seed=0)
MOE = (("moe_experts", 4), ("moe_top_k", 2), ("depth", 2))
# A spawn of 4 CPU ranks takes about 5 s; a case's steps, eval and
# resume a few seconds more.
RANKS_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Case:
    mesh: str             # --mesh-shape of both trainers
    flags: tuple = ()     # ((field, value), ...) of both configs
    jax_mesh: str = ""    # the JAX trainer's, where it differs
    sample: bool = dataclasses.field(default=False, compare=False)

    @property
    def id(self) -> str:
        extra = "".join(f"-{k}={v}" for k, v in self.flags)
        return f"{self.mesh}{extra}"

    @property
    def world(self) -> int:
        return int(np.prod([int(p.split(":")[1])
                            for p in self.mesh.split(",")]))

    @property
    def cfg(self) -> dict:
        return {**BASE, **dict(self.flags)}


def _standard(tr, tree):
    """A host copy of a tree of the JAX trainer's layout (its params or
    a tree of their shape) in the standard layout, its `_host_params`."""
    import jax

    from mpi_cuda_cnn_tpu.parallel.pp_lm import unstack_blocks
    from mpi_cuda_cnn_tpu.parallel.tp_pp_lm import unstack_tp_blocks
    from mpi_cuda_cnn_tpu.parallel.tp_sp import from_tp_layout

    p = jax.device_get(tree)
    if "rest" in p:
        if p["blocks"]["wo"].ndim == 4:
            return unstack_tp_blocks(p, tr.model)
        return unstack_blocks(p, tr.model.depth)
    if p["blocks"] and p["blocks"][0]["wo"].ndim == 3:
        return from_tp_layout(p, tr.model)
    return p


def _leaves(tree) -> list[np.ndarray]:
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _jax_trainer(cfg: dict, mesh: str, world: int, ckpt_dir=None,
                 metrics=None):
    from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
    from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig

    return JaxLMTrainer(JaxLMConfig(
        num_devices=world, mesh_shape=mesh,
        checkpoint_dir=None if ckpt_dir is None else str(ckpt_dir), **cfg),
        metrics=metrics)


_MODEL_KEYS = ("dim", "depth", "heads", "kv_heads", "pos", "moe_experts",
               "moe_top_k")
_DENSE_GRADS: dict = {}   # the plain loss's gradients, by model and batch


def _first_batch(cfg: dict):
    """Step 0's windows of the synthetic corpus, as both trainers draw
    them: (seq_len + 1)-windows from default_rng((seed, 0))."""
    stream = (np.arange(1 << 20) % 251).astype(np.int32)
    train = stream[:max(len(stream) - len(stream) // 10, cfg["seq_len"] + 1)]
    rng = np.random.default_rng((cfg["seed"], 0))
    starts = rng.integers(0, len(train) - cfg["seq_len"],
                          size=cfg["batch_size"])
    w = train[starts[:, None] + np.arange(cfg["seq_len"] + 1)[None, :]]
    return w[:, :-1], w[:, 1:]


def jax_first_grads(case: Case, init) -> list[np.ndarray]:
    """The gradients of the first step (standard leaves): the plain loss's
    of the first batch for a dense model; for an MoE model the JAX
    trainer's step on the case's mesh with an optimizer that keeps the
    gradient as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
    from mpi_cuda_cnn_tpu.train import lm_trainer
    from mpi_cuda_cnn_tpu.train.lm import get_attn_fn, lm_loss

    cfg = case.cfg
    if not cfg.get("moe_experts"):
        model = JaxLM(**{k: cfg[k] for k in _MODEL_KEYS if k in cfg},
                      vocab=251, max_seq=cfg["seq_len"])
        key = (model, cfg["batch_size"], cfg["seed"])
        if key not in _DENSE_GRADS:
            tokens, targets = _first_batch(cfg)
            _DENSE_GRADS[key] = _leaves(jax.jit(jax.grad(lambda p: lm_loss(
                model, p, tokens, targets, attn_fn=get_attn_fn("oracle"))))(
                    init))
        return _DENSE_GRADS[key]

    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    made = lm_trainer.make_optimizer
    lm_trainer.make_optimizer = lambda *a, **k: keep
    try:
        tr = _jax_trainer({**cfg, "steps": 1, "fsdp": False},
                          case.jax_mesh or case.mesh, case.world)
    finally:
        lm_trainer.make_optimizer = made
    tokens, targets = tr._sample_batch(0)
    state, _ = tr.train_step(tr.state, tr._place(tokens),
                             tr._place(targets))
    return _leaves(_standard(tr, state["opt_state"]))


def jax_run(case: Case, ckpt_dir) -> dict:
    """The JAX trainer's STEPS steps of `case` (checkpointed to ckpt_dir):
    its init, first-step gradients, final params (standard leaves),
    per-step losses, eval loss, and the trainer itself (for a
    restore)."""
    import jax

    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics

    metrics = JaxMetrics(echo=False, capture=True)
    tr = _jax_trainer(case.cfg, case.jax_mesh or case.mesh, case.world,
                      ckpt_dir, metrics)
    init = jax.device_get(tr.model.init(jax.random.key(case.cfg["seed"])))
    result = tr.train()
    sample = (np.asarray(tr.sample(SAMPLE_TOKENS)[1]).tolist()
              if case.sample else None)
    return {"init": init, "grads": jax_first_grads(case, init),
            "sample": sample,
            "params": _leaves(tr._host_params()),
            "losses": [r["loss"] for r in metrics.rows
                       if r["event"] == "train"],
            "eval": result.eval_loss, "trainer": tr}


def port_cfg(case: Case, ckpt_dir, **kw) -> LMConfig:
    return LMConfig(device="cpu", mesh_shape=case.mesh,
                    checkpoint_dir=str(ckpt_dir), **case.cfg, **kw)


def port_runs(cases: list[Case], want: dict, tmp) -> dict:
    """Each case of one world on the port's ranks, in one spawn: the run
    from the JAX init (first gradients and final params too) and a
    resume of a copy of the JAX case's checkpoint. Returns {case.id:
    (run ranks, resume ranks)}."""
    world = {c.world for c in cases}
    assert len(world) == 1, world
    runs = []
    for c in cases:
        dst = tmp / f"resume-{c.id}"
        shutil.copytree(tmp / f"jax-{c.id}", dst)
        init = params_from_jax(want[c.id]["init"])
        runs.append((port_cfg(c, tmp / f"port-{c.id}"), init,
                     {"grads": True, "final_params": True}))
        runs.append((port_cfg(c, dst, resume=True, sample_tokens=(
            SAMPLE_TOKENS if c.sample else 0)), init, {"final_params": True}))
    ranks = run_ranks(lm_rank_runs, world.pop(), args=(runs,),
                      timeout=RANKS_TIMEOUT_S)
    return {c.id: ([r[2 * i] for r in ranks], [r[2 * i + 1] for r in ranks])
            for i, c in enumerate(cases)}


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def assert_params(case: Case, got: list, want: list) -> None:
    """The params after the steps: per leaf within PARAM_REL relative L2;
    an MoE model's in tests/test_torch_moe.py's band (every element
    within 2 lr x steps, 99.9% of them within MOE_PARAM_ATOL: a routing
    choice or an AdamW sign at rounding noise may flip)."""
    for p, j in zip(got, want, strict=True):
        assert p.shape == j.shape
        if not case.cfg.get("moe_experts"):
            assert rel_l2(p, j) <= PARAM_REL, (case.id, rel_l2(p, j))
    if case.cfg.get("moe_experts"):
        diffs = np.concatenate([np.abs(p - j).ravel()
                                for p, j in zip(got, want)])
        assert diffs.max() <= 2 * case.cfg["lr"] * STEPS, case.id
        assert np.quantile(diffs, 0.999) <= MOE_PARAM_ATOL, case.id


def assert_case(case: Case, port: tuple, want: dict, tmp) -> None:
    """Every rank of the port's run against the JAX run of `case`, the
    port's resume of the JAX file bit for bit, and the JAX trainer's
    restore of the port's file bit for bit."""
    from mpi_cuda_cnn_tpu.train.checkpoint import restore_latest

    runs, resumes = port
    for res in runs:
        assert res["exit"] == 0
        for g, j in zip(res["grads"], want["grads"], strict=True):
            assert g.shape == j.shape
            assert rel_l2(g, j) <= GRAD_REL, (case.id, rel_l2(g, j))
        assert_params(case, res["params"], want["params"])
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["eval_loss"], want["eval"],
                                   rtol=LOSS_RTOL)
    for res in runs[1:]:   # every rank holds the same whole params
        for a, b in zip(res["params"], runs[0]["params"]):
            np.testing.assert_array_equal(a, b)
    for res in resumes:
        assert res["exit"] == 0
        for p, j in zip(res["params"], want["params"], strict=True):
            np.testing.assert_array_equal(p, j)
    if case.sample:
        n_model = int(dict(p.split(":") for p in case.mesh.split(","))
                      .get("model", 1))
        sampled = [r for r in resumes if r["sample"] is not None]
        assert len(sampled) == (case.world if n_model > 1 else 1), case.id
        for res in sampled:
            assert res["sample"] == want["sample"], case.id
        if n_model > 1:
            whole = one_device_cache_bytes(case)
            for res in sampled:
                assert res["sample_cache_bytes"] * n_model == whole, case.id
    tr = want["trainer"]
    restored, path = restore_latest(tmp / f"port-{case.id}",
                                    tr.state)
    assert path is not None and path.name == f"ckpt_{STEPS}.npz"
    tr._place_host_state(restored)
    for p, j in zip(_leaves(tr._host_params()), runs[0]["params"],
                    strict=True):
        np.testing.assert_array_equal(p, j)


def one_device_cache_bytes(case: Case) -> int:
    """The bytes of one device's decode cache for `case`'s model at the
    sample's default cache dtype (the port's `LocalDecoder` prefill of
    one token: the buffers hold max_seq positions)."""
    import torch

    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.models.generate import (
        LocalDecoder,
        pick_cache_dtype,
    )
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM

    cfg = case.cfg
    model = TransformerLM(**{k: cfg[k] for k in _MODEL_KEYS if k in cfg},
                          vocab=251, max_seq=cfg["seq_len"])
    dec = LocalDecoder(model, model.init(prng.key(0)))
    dec.prefill(torch.zeros((1, 1), dtype=torch.int64), pick_cache_dtype(
        LMConfig().decode_cache_dtype, heads=model.heads,
        kv_heads=model.n_kv))
    return dec.cache_bytes


def run_world(cases: list[Case], tmp) -> dict:
    """The JAX runs and the port's ranks of `cases` (one world size):
    (want by case id, port by case id)."""
    want = {c.id: jax_run(c, tmp / f"jax-{c.id}") for c in cases}
    return want, port_runs(cases, want, tmp)

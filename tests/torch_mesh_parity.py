"""What tests/test_torch_{tp,fsdp,pp,tp_pp}.py share: the JAX trainer on
conftest's 8 CPU devices as the oracle of the port's sharded CNN meshes.

Each case is a model, a mesh and flags. The JAX trainer takes STEPS
steps of its scanned epoch on synthetic_stripes(N_TRAIN, N_TEST) from the
seeded init, logging every step, evaluates and checkpoints; the port
takes the same steps on gloo CPU ranks through `cnn_rank_each` (one spawn
of the ranks for every case of a world size), from the same params, and
also resumes the JAX file. The first-step gradients are held to the JAX
loss's own gradient of the first batch (what every JAX mesh's step
differentiates), per leaf within GRAD_REL relative L2; the params after
the steps within PARAM_ATOL; the logged per-step losses within LOSS_RTOL
relative; the eval's correct count exactly. A checkpoint of each package
restores in the other on the same mesh, bit for bit.
"""

from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.data.pipeline import normalize_images as jax_norm
from mpi_cuda_cnn_tpu.data.pipeline import one_hot as jax_one_hot
from mpi_cuda_cnn_tpu.models.initializers import get_initializer
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.parallel.pp import unpack_params as jax_unpack
from mpi_cuda_cnn_tpu.train.checkpoint import restore_latest as jax_restore
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.train.trainer import make_loss_fn as jax_loss_fn
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank_each
from mpi_cuda_cnn_tpu_torch.utils.config import Config

N_TRAIN, N_TEST, BATCH = 128, 64, 32
STEPS = N_TRAIN // BATCH
GRAD_REL = 1e-5
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
# A spawn of 4 CPU ranks takes about 5 s; a case's 4 steps, its eval and
# its resume a few seconds more.
RANKS_TIMEOUT_S = 400


@dataclasses.dataclass(frozen=True)
class Case:
    model: str
    mesh: str             # the port's --mesh-shape
    flags: tuple = ()     # ((field, value), ...) of both configs
    jax_mesh: str = ""    # the JAX trainer's, where it differs

    @property
    def id(self) -> str:
        extra = "".join(f"-{k}={v}" for k, v in self.flags)
        return f"{self.model}-{self.mesh}{extra}"

    @property
    def world(self) -> int:
        return int(np.prod([int(p.split(":")[1])
                            for p in self.mesh.split(",")]))


def _jax_init(model_name: str):
    model = JAX_PRESETS[model_name]()
    return jax.device_get(model.init(jax.random.key(0),
                                     get_initializer("normal")))


def _first_batch():
    ds = jax_stripes(N_TRAIN, N_TEST)
    rows = np.random.default_rng((0, 0)).permutation(N_TRAIN)[:BATCH]
    return (jax_norm(ds.train_images[rows]),
            jax_one_hot(np.asarray(ds.train_labels)[rows], ds.num_classes))


def jax_run(case: Case, ckpt_dir) -> dict:
    """The JAX trainer's STEPS steps of `case` (checkpointed to
    ckpt_dir): init, first-step gradients, final params (whole leaves),
    per-step losses, eval, and the trainer itself (for a restore)."""
    model = JAX_PRESETS[case.model]()
    mesh = case.jax_mesh or case.mesh
    cfg = JaxConfig(model=case.model, epochs=1, batch_size=BATCH, lr=0.1,
                    mesh_shape=mesh, num_devices=case.world, log_every=1,
                    eval_every=0, checkpoint_dir=str(ckpt_dir),
                    **dict(case.flags))
    metrics = JaxMetrics(echo=False, capture=True)
    tr = JaxTrainer(model, jax_stripes(N_TRAIN, N_TEST), cfg,
                    metrics=metrics)
    init = _jax_init(case.model)
    x, y = _first_batch()
    loss_fn = jax_loss_fn(model, backend="xla")
    grads = jax.grad(lambda p: loss_fn(p, jnp.asarray(x),
                                       jnp.asarray(y))[0])(init)
    result = tr.train()
    return {"init": init, "grads": [np.asarray(g) for g in
                                    jax.tree.leaves(grads)],
            "params": jax_params(tr), "eval": (result.ntests,
                                                result.ncorrect),
            "losses": [r["loss"] for r in metrics.rows
                       if r["event"] == "train"],
            "trainer": tr}


def jax_params(tr) -> list[np.ndarray]:
    """The JAX trainer's whole param leaves (unpacked on the pipe axis)."""
    if tr.n_pipe > 1:
        params = jax_unpack(tr._pp_plan, jax.device_get(
            tr.state["flat_params"]))
    else:
        params = jax.device_get(tr.state["params"])
    return [np.asarray(p) for p in jax.tree.leaves(params)]


def port_cfg(case: Case, ckpt_dir, **kw) -> Config:
    return Config(model=case.model, epochs=1, batch_size=BATCH, lr=0.1,
                  device="cpu", mesh_shape=case.mesh, log_every=1,
                  eval_every=0, checkpoint_dir=str(ckpt_dir),
                  **dict(case.flags), **kw)


def port_runs(cases: list[Case], want: dict, tmp) -> dict:
    """Each case of one world on the port's ranks, in one spawn: the run
    from the JAX init (first gradients too) and a resume of a copy of the
    JAX case's checkpoint. Returns {case.id: (run ranks, resume ranks)}."""
    world = {c.world for c in cases}
    assert len(world) == 1, world
    runs = []
    for c in cases:
        src = tmp / f"jax-{c.id}"
        dst = tmp / f"resume-{c.id}"
        shutil.copytree(src, dst)
        init = params_from_jax(want[c.id]["init"])
        data = dict(num_train=N_TRAIN, num_test=N_TEST)
        runs.append((port_cfg(c, tmp / f"port-{c.id}"), data, init,
                     {"grads": True}))
        runs.append((port_cfg(c, dst, resume=True), data, init, {}))
    ranks = run_ranks(cnn_rank_each, world.pop(), args=(runs,),
                      timeout=RANKS_TIMEOUT_S)
    return {c.id: ([r[2 * i] for r in ranks], [r[2 * i + 1] for r in ranks])
            for i, c in enumerate(cases)}


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def assert_case(case: Case, port: tuple, want: dict, tmp) -> None:
    """Every rank of the port's run against the JAX run of `case`, the
    port's resume of the JAX file bit for bit, and the JAX trainer's
    restore of the port's file bit for bit."""
    runs, resumes = port
    for res in runs:
        assert res["exit"] == 0 and res["step"] == STEPS
        for g, j in zip(res["grads"], want["grads"], strict=True):
            assert g.shape == j.shape
            # augmented, the step differentiates another batch (its params
            # and losses are held below)
            if "augment" not in dict(case.flags):
                assert rel_l2(g, j) <= GRAD_REL
        for p, j in zip(res["params"], want["params"], strict=True):
            np.testing.assert_allclose(p, j, rtol=0, atol=PARAM_ATOL)
        losses = [r["loss"] for r in res["records"] if r["event"] == "train"]
        assert len(losses) == STEPS
        np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
        assert res["eval"] == want["eval"]
    for res in runs[1:]:   # every rank holds the same whole params
        for a, b in zip(res["params"], runs[0]["params"]):
            np.testing.assert_array_equal(a, b)
    for res in resumes:
        assert res["exit"] == 0 and res["step"] == STEPS
        for p, j in zip(res["params"], want["params"], strict=True):
            np.testing.assert_array_equal(p, j)
    tr = want["trainer"]
    restored, path = jax_restore(tmp / f"port-{case.id}", tr.state)
    assert path is not None and path.name == f"ckpt_{STEPS}.npz"
    tr.place_state(restored)
    for p, j in zip(jax_params(tr), runs[0]["params"], strict=True):
        np.testing.assert_array_equal(p, j)

"""The port's sequence-parallel LM trainer against the JAX package's on
the CPU: `LMTrainer` at `--mesh-shape seq:2`, `seq:4` and `data:2,seq:2`
on spawned gloo ranks, against the JAX `LMTrainer` on a mesh of as many
of conftest's host devices, each from its own `--seed 0` init (the two
packages draw the same weights). `ring` (what "auto" resolves to on the
CPU) and `ulysses`, one case with `--grad-accum 2` and one with
`--ce-chunk`: the 3 steps' losses within LOSS_TOL and the final params
within PARAM_REL_L2 per leaf, on every rank. A world's cases run in one
spawn of its ranks (each case on its own mesh of that world). Also the
LM's new refusals and the `lm` command at `seq:2`. The JAX package's
trainer is imported where it runs: a spawned rank imports this module
for `_cases_rank` and needs none of it.
"""

import logging

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.parallel import mesh as port_mesh
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.parallel.sp import sp_shard_batch
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer, pick_ring_impl
from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig, check_lm_supported
from mpi_cuda_cnn_tpu_torch.utils.logging import get_logger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

LOSS_TOL = 1e-5
PARAM_REL_L2 = 1e-5
STEPS = 3
RANKS_TIMEOUT_S = 240
BASE = dict(corpus="synthetic", dim=32, depth=1, heads=4, seq_len=64,
            batch_size=4, steps=STEPS, warmup_steps=1, lr=3e-3,
            log_every=1, seed=0)
CASES = {  # name: (world, flags)
    "seq2_ring": (2, dict(mesh_shape="seq:2")),
    "seq2_ulysses": (2, dict(mesh_shape="seq:2", attn_impl="ulysses")),
    "seq2_ring_accum2": (2, dict(mesh_shape="seq:2", grad_accum=2)),
    "seq4_ring": (4, dict(mesh_shape="seq:4")),
    "data2_seq2_ring": (4, dict(mesh_shape="data:2,seq:2")),
    "data2_seq2_ce_chunk": (4, dict(mesh_shape="data:2,seq:2", ce_chunk=16)),
}


@pytest.fixture
def log_lines():
    """Records of the port's logger (it does not propagate to root)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def _axes(spec: str) -> dict[str, int]:
    return {a: int(n) for a, n in (p.split(":") for p in spec.split(","))}


def _cases_rank(mesh, names):
    """Each named case on this world's ranks, each on its own mesh."""
    out = {}
    for name in names:
        world, flags = CASES[name]
        m = port_mesh.make_mesh(_axes(flags["mesh_shape"]),
                                devices=[mesh.device] * world)
        out[name] = lm_rank(m, LMConfig(device="cpu", **BASE, **flags),
                            final_params=True)
    return out


@pytest.fixture(scope="module")
def port_runs():
    """name -> the ranks' results, one spawn per world on first use."""
    runs = {}

    def get(name):
        world = CASES[name][0]
        if name not in runs:
            names = [n for n, (w, _) in CASES.items() if w == world]
            ranks = run_ranks(_cases_rank, world, args=(names,),
                              timeout=RANKS_TIMEOUT_S)
            for n in names:
                runs[n] = [r[n] for r in ranks]
        return runs[name]

    return get


def _jax_run(world, flags):
    """The JAX trainer's logged losses and final params (leaf order)."""
    from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
    from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics

    metrics = JaxMetrics(echo=False, capture=True)
    tr = JaxLMTrainer(JaxLMConfig(num_devices=world, **BASE, **flags),
                      metrics=metrics)
    res = tr.train()
    losses = [r["loss"] for r in metrics.rows if r["event"] == "train"]
    return losses, res, [np.asarray(x) for x in
                         jax.tree.leaves(jax.device_get(tr.state["params"]))]


@pytest.mark.parametrize("name", list(CASES))
def test_sp_trainer_matches_the_jax_trainer(port_runs, name):
    world, flags = CASES[name]
    losses, jres, jparams = _jax_run(world, flags)
    assert len(losses) == STEPS
    for res in port_runs(name):
        assert res["exit"] == 0
        np.testing.assert_allclose(res["losses"], losses, rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(res["eval_loss"], jres.eval_loss,
                                   rtol=LOSS_TOL)
        assert len(res["params"]) == len(jparams)
        for got, want in zip(res["params"], jparams):
            assert got.shape == want.shape
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= PARAM_REL_L2, (name, rel)
        # one all-reduce a step (data x seq) and one of the preemption
        # flags at its end, none in the replicated eval
        assert res["counts"]["collectives"]["all_reduce"] == 2 * STEPS


def test_each_rank_takes_its_block_of_the_windows():
    tokens = np.arange(4 * 64).reshape(4, 64)
    for rank in range(4):
        mesh = port_mesh.Mesh(shape={"data": 2, "seq": 2}, rank=rank,
                              world=4, device=None, group=None)
        d, s = divmod(rank, 2)      # the last axis varies fastest
        assert (mesh.index("data"), mesh.index("seq")) == (d, s)
        np.testing.assert_array_equal(sp_shard_batch(tokens, mesh),
                                      tokens[2 * d:2 * d + 2,
                                             32 * s:32 * s + 32])
    assert port_mesh.axis_lines({"data": 2, "seq": 2}, "seq") == [[0, 1],
                                                                   [2, 3]]
    assert port_mesh.axis_lines({"data": 2, "seq": 2}, "data") == [[0, 2],
                                                                    [1, 3]]


def test_ring_impl_follows_the_reference_rule():
    assert pick_ring_impl("auto", 2048, 2, "cuda", 64) == "ring_flash"
    assert pick_ring_impl("flash", 2048, 2, "cuda", 16) == "ring_flash"
    assert pick_ring_impl("auto", 2048, 32, "cuda", 64) == "ring"   # s 64
    # every head dim up to 256 takes ring-flash (padded to the kernels'
    # next instance), beyond it the plain ring
    for d in (24, 80, 96, 200, 256):
        assert pick_ring_impl("auto", 2048, 2, "cuda", d) == "ring_flash"
    assert pick_ring_impl("auto", 2048, 2, "cuda", 320) == "ring"
    # an explicit flash is not turned into plain attention at a head dim
    # the kernels do not take: they refuse it, as off the seq axis
    assert pick_ring_impl("flash", 2048, 2, "cuda", 320) == "ring_flash"
    assert pick_ring_impl("flash", 2048, 32, "cuda", 64) == "ring"   # s 64
    assert pick_ring_impl("auto", 2048, 2, "cpu", 64) == "ring"
    assert pick_ring_impl("oracle", 2048, 2, "cuda", 64) == "ring"
    assert pick_ring_impl("ulysses", 2048, 2, "cuda", 64) == "ulysses"


@pytest.mark.parametrize("flags", [
    dict(mesh_shape="seq:2", moe_experts=4),
    dict(mesh_shape="data:2,seq:2", fsdp=True)], ids=["moe", "fsdp"])
def test_moe_and_fsdp_under_seq_exit_2_naming_queue_f_item_1(flags, capfd):
    """MoE under a seq axis (EP x SP) and --fsdp beside it (FSDP x SP)
    are ported: the command runs on gloo CPU ranks and exits 0."""
    argv = ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
            "--depth", "1", "--heads", "2", "--seq-len", "64",
            "--batch-size", "4", "--steps", "1"]
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    axes = check_lm_supported(LMConfig(**flags))
    assert {a: n for a, n in axes.items() if n > 1} == \
        _axes(flags["mesh_shape"])
    assert main(argv) == 0
    assert capfd.readouterr().err.count("lm done: steps=1") == 1


@pytest.mark.parametrize("flags,match", [
    (dict(mesh_shape="seq:2", elastic_width=4),
     "--elastic-width needs a pure data-parallel mesh"),
    (dict(mesh_shape="seq:3", seq_len=64),
     "seq_len 64 not divisible by seq-axis size 3")])
def test_what_the_seq_axis_refuses(flags, match):
    with pytest.raises(ValueError, match=match):
        check_lm_supported(LMConfig(**flags))


def test_seq_mesh_needs_ranks():
    with pytest.raises(ValueError, match="an LMTrainer is one rank"):
        LMTrainer(LMConfig(device="cpu", mesh_shape="seq:2", **dict(
            BASE, steps=1)))


def test_cli_lm_at_seq_2(capfd):
    argv = ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
            "--depth", "1", "--heads", "2", "--seq-len", "64",
            "--batch-size", "2", "--steps", "2", "--log-every", "1",
            "--mesh-shape", "seq:2"]
    assert main(argv) == 0
    err = capfd.readouterr().err      # the ranks' stderr: rank 0 echoes
    assert err.count("lm done: steps=2") == 1, err
    assert "attn=ring" in err

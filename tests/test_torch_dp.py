"""The port's data parallelism (`mpi_cuda_cnn_tpu_torch/parallel`, the
CNN `Trainer` and the `train` command on a data mesh) against the JAX
package's DP trainer on the CPU.

The port runs one process per rank over gloo (`run_ranks`, spawned CPU
ranks); the JAX trainer runs `JaxConfig(num_devices=w, scan=False)` on w
of conftest's 8 host devices. From the JAX trainer's initial params,
8 SGD steps of reference_cnn on synthetic_stripes(256, 64) at batch 32
run at world 2 and 4 on both of the port's epoch routes: params agree
within PARAM_ATOL (as the one-device parity, tests/test_torch_train.py),
the loss within rtol 1e-5, the accuracy and the eval counts exactly. The
JAX `pmean` over 4 devices need not add in gloo's order; host-side
decisions (the permutation, the shard boundaries) are held bit for bit.
One world-2 and one world-4 run per module are shared by a fixture.
"""

import dataclasses
import logging
import math
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.parallel.mesh import describe_mesh as jax_describe_mesh
from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import parse_mesh_shape as jax_parse_mesh
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch import cli
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel import dp
from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
    RankError,
    pick_backend,
    process_group,
    run_ranks,
)
from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh, describe_mesh, make_mesh
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import (
    Config,
    check_supported,
    parse_mesh_shape,
)
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger, get_logger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# As tests/test_torch_train.py: 8 float32 SGD steps from equal params,
# sums in other orders (here also the all-reduce's), about 30 ulp of the
# largest params.
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
N_TRAIN, N_TEST, BATCH = 256, 64, 32
STEPS = N_TRAIN // BATCH
WORLDS = (2, 4)
ROUTES = {"device": True, "per_batch": False}
# Spawning 4 CPU ranks takes about 4 s; a rank's 8 steps and eval, both
# routes, well under a second each.
RANKS_TIMEOUT_S = 240


def _cfg(**kw):
    base = dict(epochs=1, batch_size=BATCH, lr=0.1, device="cpu",
                log_every=0, eval_every=0)
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_dp_runs():
    """8 steps of the JAX DP trainer at each world from one init: its
    initial params, final params, epoch metrics and eval counts."""
    ds = jax_stripes(N_TRAIN, N_TEST)
    out = {}
    for w in (1, *WORLDS):
        cfg = JaxConfig(epochs=1, batch_size=BATCH, lr=0.1, num_devices=w,
                        scan=False, log_every=0, eval_every=0)
        tr = JaxTrainer(JAX_PRESETS["reference_cnn"](), ds, cfg,
                        metrics=JaxMetrics(echo=False))
        init = jax.device_get(tr.state["params"])
        em = tr.run_epoch(0)
        params = jax.tree.leaves(jax.device_get(tr.state["params"]))
        out[w] = {"init": init, "params": params, "eval": tr.evaluate(),
                  "loss": em["loss"], "acc": em["acc"]}
    return out


@pytest.fixture(scope="module")
def port_dp_runs(jax_dp_runs):
    """The port at each world on spawned gloo ranks, on each epoch route,
    from the JAX trainer's initial params: each rank's results."""
    return {w: {route: run_ranks(cnn_rank, w, args=(
                    _cfg(scan=scan), dict(num_train=N_TRAIN, num_test=N_TEST),
                    params_from_jax(jax_dp_runs[w]["init"])),
                    timeout=RANKS_TIMEOUT_S)
                for route, scan in ROUTES.items()}
            for w in WORLDS}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("w", WORLDS)
def test_dp_matches_the_jax_dp_trainer(jax_dp_runs, port_dp_runs, w, route):
    want = jax_dp_runs[w]
    ranks = port_dp_runs[w][route]
    assert len(ranks) == w
    for res in ranks:
        assert res["step"] == STEPS and res["epoch"]["steps"] == STEPS
        for g, j in zip(res["params"], want["params"], strict=True):
            assert g.shape == j.shape
            np.testing.assert_allclose(g, j, rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(res["epoch"]["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        assert res["epoch"]["acc"] == want["acc"]
        assert res["eval"] == want["eval"]
    for res in ranks[1:]:   # one update on every rank: the same params
        for a, b in zip(res["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", WORLDS)
def test_one_all_reduce_per_step_and_one_broadcast(port_dp_runs, w):
    for route, ranks in port_dp_runs[w].items():
        # and one all-reduce of the preemption flags at every chunk
        # boundary: the device route's epoch is one chunk, the per-batch
        # route ends one at every step
        flags = 1 if route == "device" else STEPS
        for res in ranks:
            assert res["init"]["collectives"] == {"all_reduce": 0,
                                                  "broadcast": 1}
            assert res["epoch_counts"]["collectives"] == {
                "all_reduce": STEPS + flags, "broadcast": 0}
            # the eval's correct counts: one sum over the ranks
            assert res["eval_counts"]["collectives"] == {"all_reduce": 1,
                                                         "broadcast": 0}
            assert set(res["epoch_counts"]["launches"].values()) == {0}


@pytest.mark.parametrize("route", ROUTES)
def test_world_one_is_bitwise_the_one_device_trainer(jax_dp_runs, tmp_path,
                                                     route):
    """make_dp_train_step on a one-rank gloo group (its all-reduce the
    identity) against the one-device Trainer, which makes no collective."""
    params = params_from_jax(jax_dp_runs[1]["init"])
    cfg = _cfg(scan=ROUTES[route])
    with process_group("gloo", 0, 1, str(tmp_path / "store")):
        res = cnn_rank(make_mesh(devices=[torch.device("cpu")]), cfg,
                       dict(num_train=N_TRAIN, num_test=N_TEST), params)
    assert res["init"]["collectives"] == {"all_reduce": 0, "broadcast": 1}
    assert res["epoch_counts"]["collectives"]["all_reduce"] == STEPS
    dp.reset_collectives()
    tr = Trainer(get_model("reference_cnn"),
                 synthetic_stripes(N_TRAIN, N_TEST), cfg,
                 metrics=MetricsLogger(echo=False), params=params)
    em = tr.run_epoch(0)
    assert dp.collectives == {"all_reduce": 0, "broadcast": 0}
    for a, b in zip(res["params"], tr.leaves, strict=True):
        np.testing.assert_array_equal(a, b.detach().numpy())
    assert res["epoch"]["loss"] == em["loss"] and res["eval"] == tr.evaluate()
    np.testing.assert_allclose(em["loss"], jax_dp_runs[1]["loss"],
                               rtol=LOSS_RTOL)


def _rank_mesh(w: int, r: int) -> Mesh:
    return Mesh(shape={"data": w}, rank=r, world=w,
                device=torch.device("cpu"), group=None)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_shard_boundaries_are_jax_shardings(eight_devices, w):
    """dp_shard_perm is P(None, 'data') and dp_shard_batch is P('data')
    on the first w devices, rank r holding device r's block."""
    mesh = jax_make_mesh({"data": w}, devices=eight_devices[:w])
    perm = np.random.default_rng(0).permutation(8 * BATCH).astype(
        np.int32).reshape(8, BATCH)
    by_dev = {s.device.id: np.asarray(s.data) for s in jax.device_put(
        perm, NamedSharding(mesh, P(None, "data"))).addressable_shards}
    rows = {s.device.id: np.asarray(s.data) for s in jax.device_put(
        perm[0], NamedSharding(mesh, P("data"))).addressable_shards}
    for r, dev in enumerate(mesh.devices.flat):
        np.testing.assert_array_equal(dp.dp_shard_perm(perm, _rank_mesh(w, r)),
                                      by_dev[dev.id])
        np.testing.assert_array_equal(
            dp.dp_shard_batch(perm[0], _rank_mesh(w, r)), rows[dev.id])
        x, y = dp.dp_shard_batch((perm[0], perm[1]), _rank_mesh(w, r))
        np.testing.assert_array_equal(y, perm[1][len(x) * r:len(x) * (r + 1)])
    with pytest.raises(ValueError, match="not divisible"):
        dp.dp_shard_batch(np.arange(30), _rank_mesh(4, 0))


@pytest.mark.parametrize("spec,total", [
    ("data", 8), ("data:4", 8), ("data:2,model:2", 8), ("data,model:2", 8),
    ("pipe:2,data", 4), (" data : 2 ", 2), ("data", 1)])
def test_parse_mesh_shape_matches_jax(spec, total):
    assert parse_mesh_shape(spec, total) == jax_parse_mesh(spec, total)


@pytest.mark.parametrize("spec,total", [("data,model", 4), ("data,model:3", 4),
                                        ("data:x", 4)])
def test_parse_mesh_shape_refuses_as_jax(spec, total):
    with pytest.raises(ValueError) as want:
        jax_parse_mesh(spec, total)
    with pytest.raises(ValueError) as got:
        parse_mesh_shape(spec, total)
    assert str(got.value) == str(want.value)


def test_make_mesh_and_describe_mesh_follow_jax(eight_devices):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError) as want:
        jax_make_mesh({"data": 4}, devices=eight_devices[:2])
    with pytest.raises(ValueError) as got:
        make_mesh({"data": 4}, devices=[cpu] * 2)
    assert str(got.value) == str(want.value)
    mesh = make_mesh()       # no process group: the world-1 data mesh
    assert (mesh.shape, mesh.rank, mesh.world, mesh.group) == (
        {"data": 1}, 0, 1, None)
    assert describe_mesh(mesh) == jax_describe_mesh(
        jax_make_mesh({"data": 1}, devices=eight_devices[:1]))
    with pytest.raises(ValueError, match="start one process per rank"):
        make_mesh({"data": 2}, devices=[cpu] * 2)


def test_batch_not_divisible_by_the_data_axis_raises_as_jax():
    with pytest.raises(ValueError) as want:
        JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
                   JaxConfig(batch_size=30, num_devices=4),
                   metrics=JaxMetrics(echo=False))
    with pytest.raises(ValueError) as got:
        check_supported(_cfg(batch_size=30, num_devices=4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        Trainer(get_model("reference_cnn"), synthetic_stripes(64, 8),
                _cfg(batch_size=30), mesh=_rank_mesh(4, 0))
    assert str(got.value) == str(want.value)
    assert main(["train", "--device", "cpu", "--batch-size", "30",
                 "--num-devices", "4"]) == 2


def test_a_trainer_without_a_mesh_is_one_rank():
    with pytest.raises(ValueError, match="a Trainer is one rank"):
        Trainer(get_model("reference_cnn"), synthetic_stripes(64, 8),
                _cfg(num_devices=2))


def test_pick_backend():
    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert pick_backend([cpu, cpu]) == "gloo"
    assert pick_backend([c0, c1]) == "nccl"
    assert pick_backend([c0, c0]) == "gloo"      # NCCL: one rank per card
    with pytest.raises(ValueError):
        pick_backend([cpu, c0])


def test_a_failing_rank_fails_the_run():
    """A rank that raises fails the run with its traceback; a rank whose
    trainer refuses its setup returns the command's exit code 2."""
    with pytest.raises(RankError, match=r"(?s)rank 1:.*TypeError: "
                                        r".*unexpected keyword.*'bogus'"):
        run_ranks(cnn_rank, 2, args=(_cfg(), dict(num_train=64, num_test=8,
                                                  bogus=1)),
                  timeout=RANKS_TIMEOUT_S)
    refused = cnn_rank(_rank_mesh(2, 1), _cfg(batch_size=33),
                       dict(num_train=64, num_test=8))
    assert refused == {"exit": 2}


@pytest.fixture
def log_lines():
    """Records of the port's logger in this process (it does not
    propagate to root; set up first, so that it keeps its INFO level)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def test_cli_train_on_two_cpu_ranks(tmp_path, capfd, log_lines):
    paths = [str(p) for p in write_synthetic_idx(
        tmp_path, synthetic_stripes(num_train=64, num_test=20)).values()]
    argv = ["train", "--device", "cpu", "--epochs", "1", "--log-every", "0",
            "--num-devices", "2", *paths]
    assert main(argv) == 0
    err = capfd.readouterr().err      # the ranks' stderr: rank 0 echoes
    assert len(re.findall(r"ntests=20, ncorrect=\d+", err)) == 1, err
    assert "ranks=2 backend=gloo devices=cpu,cpu" in log_lines
    assert main(argv[:-1]) == 100
    assert main(argv[:-1] + [str(tmp_path / "missing")]) == 111
    assert main(argv + ["--mesh-shape", "data:2,model:2"]) == 2


def test_cli_under_torchrun_is_one_rank_of_the_env_world(tmp_path,
                                                        monkeypatch,
                                                        log_lines):
    """RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR name the world (here 1, on
    a localhost store): the command runs in this process as its rank and
    spawns nothing, whatever --num-devices says."""
    import socket

    import torch.distributed as dist

    from mpi_cuda_cnn_tpu_torch.parallel import distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "run_ranks", None)   # not called
    paths = [str(p) for p in write_synthetic_idx(
        tmp_path, synthetic_stripes(num_train=64, num_test=20)).values()]
    dp.reset_collectives()
    try:
        assert main(["train", "--device", "cpu", "--epochs", "1",
                     "--log-every", "0", "--num-devices", "2", *paths]) == 0
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert dp.collectives == {"all_reduce": 2 + 1, "broadcast": 1}
    assert any(re.fullmatch(r"ntests=20, ncorrect=\d+", m) for m in log_lines)


@pytest.mark.parametrize("visible,card", [(4, 1), (1, 0)],
                         ids=["node-cards", "own-card"])
def test_a_torchrun_rank_runs_on_its_local_card(monkeypatch, visible, card):
    """Global rank 3 of a world of 4 whose local rank is 1 (its node's
    second process) runs on cuda:LOCAL_RANK where it sees the node's
    cards, on cuda:0 where its launcher shows it only its own; never on
    the card of its global rank. Cards and the NCCL group are stand-ins
    (this machine may have neither)."""
    import torch.distributed as dist

    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    current, joined = [0], {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.__setitem__(0, d.index))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(backend=backend))
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(joined))
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    want = torch.device("cuda", card)
    devices = cli.rank_devices("cuda", 0, "data", BATCH, "E")
    assert devices == [want] * 4
    info = initialize_distributed(devices[0])
    assert (joined, current[0]) == ({"backend": "nccl"}, card)
    assert (info.process_index, info.process_count) == (3, 4)
    for mesh in (make_mesh(devices=devices), make_mesh()):
        assert (mesh.shape, mesh.rank, mesh.world, mesh.device) == (
            {"data": 4}, 3, 4, want)


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_num_devices_without_cuda_raises_and_stays_off_the_cpu(
        no_gpu, monkeypatch, log_lines):
    spawned = []
    monkeypatch.setattr(cli, "_run_world", lambda *a: spawned.append(a) or 0)
    assert main(["train", "--epochs", "1", "--num-devices", "2"]) == 2
    assert main(["lm", "--corpus", "synthetic", "--num-devices", "2"]) == 2
    assert not spawned
    assert sum("CUDA device requested" in m for m in log_lines) == 2
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.rank_devices("auto", 2, "data", BATCH, "E")


@pytest.fixture
def one_gpu(monkeypatch):
    """A machine with one card, as far as the device count goes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_more_ranks_than_cards_exits_2_with_make_mesh_message(one_gpu,
                                                              monkeypatch,
                                                              log_lines):
    spawned = []
    monkeypatch.setattr(cli, "_run_world", lambda *a: spawned.append(a) or 0)
    assert cli.rank_devices("cuda", 0, "data", BATCH, "E") == [
        torch.device("cuda", 0)]
    assert main(["train", "--epochs", "1", "--num-devices", "2"]) == 2
    assert main(["lm", "--corpus", "synthetic", "--mesh-shape",
                 "data:2"]) == 2
    assert not spawned
    assert log_lines == ["mesh {'data': 2} needs 2 devices, have 1"] * 2


@pytest.mark.parametrize("kw,item", [
    (dict(mesh_shape="data:2,model:2"), 1), (dict(mesh_shape="pipe:2"), 1),
    (dict(mesh_shape="seq:2"), 1), (dict(fsdp=True, num_devices=2), 1),
    (dict(elastic_width=4, mesh_shape="data:2,model:2"), 1)])
def test_what_the_data_mesh_still_refuses(kw, item):
    """What the data mesh refused until queue E item `item` landed: the
    meshes and FSDP now pass the checks wherever the JAX trainer builds,
    and --elastic-width on a sharded mesh raises its ValueError in its
    words."""
    axes = parse_mesh_shape(kw.get("mesh_shape", "data"),
                            kw.get("num_devices", 1))
    jax_kw = {"batch_size": BATCH, "num_devices": math.prod(axes.values()),
              **kw}
    if "elastic_width" in kw:
        with pytest.raises(ValueError) as want:
            JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
                       JaxConfig(**jax_kw), metrics=JaxMetrics(echo=False))
        with pytest.raises(ValueError) as got:
            check_supported(_cfg(**kw))
        assert str(got.value) == str(want.value)
        return
    JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
               JaxConfig(**jax_kw), metrics=JaxMetrics(echo=False))
    assert check_supported(_cfg(**kw)) == axes


def test_replicate_is_one_broadcast_from_rank_zero(tmp_path):
    params = {"w": torch.full((2, 3), 7.0), "b": [torch.zeros(4)]}
    dp.reset_collectives()
    assert dp.replicate(params, _rank_mesh(1, 0)) is params   # no group
    assert dp.collectives["broadcast"] == 0
    with process_group("gloo", 0, 1, str(tmp_path / "store")):
        dp.replicate(params, make_mesh())
    assert dp.collectives == {"all_reduce": 0, "broadcast": 1}
    assert params["w"].eq(7).all() and params["b"][0].eq(0).all()


def test_dp_mean_grads_averages_grads_and_metrics(tmp_path):
    """One rank's view: the flat buffer's views carry the gradients and
    the metrics in order, divided by the data axis."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)

    def loss_fn(params, x, y):
        loss = (params["w"] * x).sum()
        return loss, {"etotal": torch.tensor(4.0), "acc": torch.tensor(0.5)}

    with process_group("gloo", 0, 1, str(tmp_path / "store")):
        mesh = dataclasses.replace(make_mesh(), shape={"data": 2})
        grads, metrics = dp.dp_mean_grads(loss_fn, {"w": w},
                                          torch.tensor([3.0, 5.0]), None, mesh)
    np.testing.assert_array_equal(grads[0].numpy(), [1.5, 2.5])
    np.testing.assert_array_equal(metrics.numpy(), [6.5, 2.0, 0.25])

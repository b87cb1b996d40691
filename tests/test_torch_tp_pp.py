"""The port's TP x PP (`parallel/pp.py` with the model-axis slices of
`parallel/tp.py`) against the JAX trainer on the CPU, on pipe:2,model:2:
reference_cnn, lenet5_relu (a pool and a flatten inside the stages, its
stage boundary after a pool), and reference_cnn with momentum and the
global-norm clip at 0.05, where it binds (the replicated leaves counted
once over 'model'), as tests/torch_mesh_parity.py sets out: first
gradients, params, losses, eval, and the reference's (S, M, Pm_max)
packed rows as checkpoints both ways. The plan and the packed rows are
held to the reference's in tests/test_torch_pp.py (n_model 2 too).
"""

import pytest
import torch

from mpi_cuda_cnn_tpu_torch import cli
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.pp import make_pipeline_plan
from torch_mesh_parity import (
    STEPS,
    Case,
    assert_case,
    jax_run,
    port_runs,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("reference_cnn", "pipe:2,model:2"),
         Case("lenet5_relu", "pipe:2,model:2"),
         Case("reference_cnn", "pipe:2,model:2",
              (("momentum", 0.9), ("grad_clip", 0.05)))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_pp")
    want = {c.id: jax_run(c, tmp / f"jax-{c.id}") for c in CASES}
    return tmp, want, port_runs(CASES, want, tmp)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_tp_pp_matches_the_jax_trainer(runs, case):
    tmp, want, port = runs
    assert_case(case, port[case.id], want[case.id], tmp)


@pytest.mark.parametrize("case", CASES[:2], ids=[c.id for c in CASES[:2]])
def test_tp_pp_collectives_are_the_plans(runs, case):
    """Per step, on the ranks of stage s: a gather per microbatch and
    sliced layer of the stage; an all-reduce per microbatch and sliced
    layer whose input has a gradient (all but the model's first layer),
    one sum of the metrics over the world and one of the preemption flags
    (every step ends a chunk at log_every 1); a send and a receive per
    microbatch."""
    _, _, port = runs
    plan = make_pipeline_plan(get_model(case.model), 2, n_model=2)
    for r, res in enumerate(port[case.id][0]):
        layers = plan.stage_layers[r // 2]      # pipe:2,model:2: r = 2p + m
        sliced = [i for i in layers if plan.layer_sliced[i]]
        coll = res["epoch_counts"]["collectives"]
        assert coll["all_gather"] == STEPS * 2 * len(sliced)
        assert coll["all_reduce"] == STEPS * (
            2 * len([i for i in sliced if i > 0]) + 2)
        assert coll["send"] == coll["recv"] == STEPS * 2


@pytest.mark.parametrize("cards", [0, 1, 4])
def test_the_command_on_a_mesh_runs_on_the_cards_or_exits_2(monkeypatch,
                                                           cards):
    """`train --mesh-shape pipe:2,model:2 --use-kernels` runs its four
    ranks on four cards (NCCL, cuda:0-3) by default; with no card, or
    fewer cards than ranks, it exits 2 and starts nothing: no CPU
    fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    worlds = []
    monkeypatch.setattr(cli, "_run_world",
                        lambda entry, devices, args, axes: worlds.append(
                            (devices, axes)) or 0)
    rc = main(["train", "--mesh-shape", "pipe:2,model:2", "--use-kernels",
               "--epochs", "1"])
    if cards < 4:
        assert rc == 2 and not worlds
        return
    assert rc == 0
    assert worlds == [([torch.device("cuda", i) for i in range(4)],
                       {"pipe": 2, "model": 2})]

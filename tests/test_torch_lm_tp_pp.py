"""The port's TP x PP LM (`parallel/lm_shard.py`: the Megatron block in
each GPipe stage, `parallel/tp_pp_lm.py`) against the JAX trainer's
(`parallel/tp_pp_lm.py`) on the CPU, as tests/torch_lm_mesh_parity.py
sets out: pipe:2,model:2 (MHA; GQA with rope), pipe:2,model:2,data:2
and pipe:2,model:2,seq:2 over 8 ranks. The full 4D mesh,
data:2,pipe:2,model:2,seq:2, needs 16 ranks, and the JAX oracle has 8
devices here: the port's 16 gloo ranks are held to the JAX one-device
trainer from the same params (as tests/test_4d_full.py holds the JAX 4D
run), and its checkpoint, whose tree 'seq' does not change, to the JAX
pipe:2,model:2,data:2 trainer both ways.
"""

import shutil
import time

import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank_runs
from torch_lm_mesh_parity import (
    GRAD_REL,
    LOSS_RTOL,
    PARAM_REL,
    STEPS,
    Case,
    _leaves,
    assert_case,
    jax_run,
    port_cfg,
    rel_l2,
    run_world,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("pipe:2,model:2", sample=True),
         Case("pipe:2,model:2", (("kv_heads", 2), ("pos", "rope"))),
         Case("pipe:2,model:2,data:2"),
         Case("pipe:2,model:2,seq:2")]
FOUR_D = Case("data:2,pipe:2,model:2,seq:2")
# 16 spawned CPU ranks: their start, the mesh's groups, 3 steps, the eval
# and a resume
FOUR_D_TIMEOUT_S = 420


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp_pp")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_tp_pp_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


def test_the_4d_mesh_on_16_ranks_matches_the_jax_trainer(runs, capsys):
    """The port on data:2,pipe:2,model:2,seq:2 against the JAX one-device
    trainer (gradients, losses, params, eval), and its checkpoint against
    the JAX pipe:2,model:2,data:2 trainer's both ways, bit for bit."""
    tmp, out = runs
    one = jax_run(Case("data:1"), tmp / "jax-one")
    want3, _ = out["pipe:2,model:2,data:2"]
    dst = tmp / "resume-4d"
    shutil.copytree(tmp / "jax-pipe:2,model:2,data:2", dst)
    init = params_from_jax(one["init"])
    t0 = time.perf_counter()
    ranks = run_ranks(lm_rank_runs, 16, args=([
        (port_cfg(FOUR_D, tmp / "port-4d"), init,
         {"grads": True, "final_params": True}),
        (port_cfg(FOUR_D, dst, resume=True), init, {"final_params": True}),
    ],), timeout=FOUR_D_TIMEOUT_S)
    with capsys.disabled():
        print(f"\n4D mesh, 16 ranks: {time.perf_counter() - t0:.1f} s")
    for run, resume in ranks:
        assert run["exit"] == 0 and resume["exit"] == 0
        for g, j in zip(run["grads"], one["grads"], strict=True):
            assert rel_l2(g, j) <= GRAD_REL
        for p, j in zip(run["params"], one["params"], strict=True):
            assert rel_l2(p, j) <= PARAM_REL
        np.testing.assert_allclose(run["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(run["eval_loss"], one["eval"],
                                   rtol=LOSS_RTOL)
        for p, j in zip(resume["params"], want3["params"], strict=True):
            np.testing.assert_array_equal(p, j)
    from mpi_cuda_cnn_tpu.train.checkpoint import restore_latest

    tr = want3["trainer"]
    restored, path = restore_latest(tmp / "port-4d", tr.state)
    assert path is not None and path.name == f"ckpt_{STEPS}.npz"
    tr._place_host_state(restored)
    for p, j in zip(_leaves(tr._host_params()), ranks[0][0]["params"],
                    strict=True):
        np.testing.assert_array_equal(p, j)

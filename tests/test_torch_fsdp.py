"""The port's FSDP (`parallel/fsdp.py`, the `ShardedCNN` step of
`parallel/tp.py`) against the JAX trainer's GSPMD FSDP on the CPU.

reference_cnn on data:2 --fsdp (with and without the global-norm clip
at 0.05, where it binds) and lenet5_relu on data:2,model:2 --fsdp (ZeRO
over Megatron), as tests/torch_mesh_parity.py sets out: first
gradients, params, losses, eval and checkpoints (whole leaves) both
ways. The blocks are the reference's `fsdp_specs`, each rank holds only
its blocks of the params and the momentum, and a step makes one gather
and one reduce-scatter over the data line.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.parallel.fsdp import fsdp_specs as jax_fsdp_specs
from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_cnn_tpu.parallel.tp import tp_param_specs as jax_tp_specs
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.fsdp import fsdp_specs
from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh
from mpi_cuda_cnn_tpu_torch.parallel.tp import ShardedCNN, tp_param_specs
from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
from torch_mesh_parity import (
    STEPS,
    Case,
    assert_case,
    jax_run,
    port_runs,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = {2: [Case("reference_cnn", "data:2", (("fsdp", True),)),
             Case("reference_cnn", "data:2", (("fsdp", True),
                                              ("momentum", 0.9),
                                              ("grad_clip", 0.05)))],
         4: [Case("lenet5_relu", "data:2,model:2", (("fsdp", True),))]}
ALL = [c for cases in CASES.values() for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    want = {c.id: jax_run(c, tmp / f"jax-{c.id}") for c in ALL}
    port = {}
    for cases in CASES.values():
        port.update(port_runs(cases, want, tmp))
    return tmp, want, port


@pytest.mark.parametrize("case", ALL, ids=[c.id for c in ALL])
def test_fsdp_matches_the_jax_trainer(runs, case):
    tmp, want, port = runs
    assert_case(case, port[case.id], want[case.id], tmp)


def test_fsdp_collectives_are_one_gather_and_one_scatter_a_step(runs):
    _, _, port = runs
    for res in port[ALL[0].id][0]:
        coll = res["epoch_counts"]["collectives"]
        assert coll["all_gather"] == STEPS
        # and the preemption flags' one all-reduce a step (log_every 1)
        assert coll["reduce_scatter"] == STEPS and coll["all_reduce"] == STEPS


def _spec_dicts(specs) -> list[dict]:
    out = []
    for s in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P)):
        out.append({a: d for d, a in enumerate(tuple(s)) if a is not None})
    return out


@pytest.mark.parametrize("name", ["reference_cnn", "lenet5_relu"])
@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 4},
                                  {"data": 2, "model": 2},
                                  {"data": 4, "model": 2}])
def test_fsdp_specs_are_the_references(eight_devices, name, axes):
    """The reference's `fsdp_specs`, over its `tp_param_specs` when the
    mesh has a model axis: the same dim of every leaf, or none."""
    jmodel = JAX_PRESETS[name]()
    jparams = jmodel.init(jax.random.key(0),
                          lambda k, s, dtype=jnp.float32: jnp.zeros(s, dtype))
    mesh = jax_make_mesh(axes,
                         devices=eight_devices[:math.prod(axes.values())])
    base = jax_tp_specs(jmodel, mesh) if "model" in axes else None
    want = _spec_dicts(jax_fsdp_specs(jparams, mesh, base_specs=base))
    model = get_model(name)
    params = model.init(prng.key(0), lambda k, s: torch.zeros(s))
    base = (tp_param_specs(model, params, axes["model"]) if "model" in axes
            else None)
    assert fsdp_specs(params, axes["data"], base_specs=base) == want


@pytest.mark.parametrize("axes", [{"data": 2}])
def test_each_rank_holds_its_blocks_of_params_and_momentum(axes):
    """At data:2 every leaf of reference_cnn has a dim to block, so the
    ranks' blocks add up to the model once; the momentum has each
    block's shape."""
    model = get_model("reference_cnn")
    params = model.init(prng.key(0), lambda k, s: torch.ones(s))
    opt = make_optimizer(0.1, momentum=0.9)
    world = math.prod(axes.values())
    held = 0
    for rank in range(world):
        mesh = Mesh(shape=axes, rank=rank, world=world,
                    device=torch.device("cpu"), group=None)
        state = ShardedCNN(model, mesh, fsdp=True,
                           backend="torch").place(params, opt)
        leaves = tree_leaves(state["params"])
        assert [t.shape for t in state["opt_state"]["trace"]] == [
            t.shape for t in leaves]
        held += sum(t.numel() for t in leaves)
    assert held == model.num_params(params) == 360_810

"""The port's tensor parallelism (`parallel/tp.py`, `parallel/
collectives.py`) against the JAX trainer's GSPMD TP on the CPU.

reference_cnn on data:2,model:2 (every layer sliced, the 10-class head
to 5 a rank), on model:4 (the head stays whole) and on data:2,model:2
with --augment shift (the whole batch's draws under the step's key), as
tests/torch_mesh_parity.py sets out: first gradients, params, losses,
eval and checkpoints both ways. The JAX trainer's model:4 fails at its
first step (its batch placement names a 'data' axis the mesh lacks), so
it runs data:1,model:4, the same TP. An axis without a path of its own
(data:2,seq:2) holds replicas of the data-parallel step, as in the JAX
trainer (its augmentation keyed by the data coordinate). The specs are
the reference's, the
collectives per step those the plan gives, and the sharded meshes
refuse --elastic-width in the reference's words.
"""

import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_cuda_cnn_tpu.parallel.tp import tp_param_specs as jax_tp_specs
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.tp import tp_param_specs, tp_sliced
from mpi_cuda_cnn_tpu_torch.utils.config import Config, check_supported
from torch_mesh_parity import (
    STEPS,
    Case,
    assert_case,
    jax_run,
    port_runs,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("reference_cnn", "data:2,model:2"),
         Case("reference_cnn", "model:4", jax_mesh="data:1,model:4"),
         Case("reference_cnn", "data:2,model:2", (("augment", "shift"),)),
         Case("reference_cnn", "data:2,seq:2", (("augment", "shift"),))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    want = {c.id: jax_run(c, tmp / f"jax-{c.id}") for c in CASES}
    return tmp, want, port_runs(CASES, want, tmp)


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_tp_matches_the_jax_trainer(runs, case):
    tmp, want, port = runs
    assert_case(case, port[case.id], want[case.id], tmp)


@pytest.mark.parametrize("case", CASES[:2], ids=[c.id for c in CASES[:2]])
def test_tp_collectives_are_the_plans(runs, case):
    """Per step: one all-gather a sliced layer; one all-reduce a sliced
    layer whose input has a gradient (all but the first layer's), one
    for the data mean and one of the preemption flags (every step ends a
    chunk at log_every 1). After the steps: the final checkpoint's one
    all-reduce of the whole state, then the eval's gathers (one forward
    of its one batch) and one sum of the counts over the data line."""
    _, _, port = runs
    n_model = 4 if case.mesh == "model:4" else 2
    n_data = 1 if case.mesh == "model:4" else 2
    sliced = tp_sliced(get_model(case.model), n_model)
    for res in port[case.id][0]:
        coll = res["epoch_counts"]["collectives"]
        assert coll["all_gather"] == STEPS * sum(sliced)
        assert coll["all_reduce"] == STEPS * (sum(sliced[1:]) + (n_data > 1)
                                              + 1)
        ev = res["eval_counts"]["collectives"]
        assert ev["all_gather"] == sum(sliced)
        assert ev["all_reduce"] == 1 + (n_data > 1)


@pytest.mark.parametrize("name", ["reference_cnn", "lenet5_relu"])
@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"model": 4},
                                  {"data": 1, "model": 8}])
def test_tp_param_specs_are_the_references(eight_devices, name, axes):
    jmodel = JAX_PRESETS[name]()
    mesh = jax_make_mesh(axes,
                         devices=eight_devices[:math.prod(axes.values())])
    want = [{"model": list(s).index("model")} if "model" in tuple(s) else {}
            for s in jax.tree.leaves(jax_tp_specs(jmodel, mesh),
                                     is_leaf=lambda x: isinstance(x, P))]
    model = get_model(name)
    params = model.init(prng.key(0), lambda k, s: torch.zeros(s))
    assert tp_param_specs(model, params, axes["model"]) == want


@pytest.mark.parametrize("mesh_shape,fsdp", [("data:2,model:2", False),
                                             ("data:2", True),
                                             ("pipe:2,data:2", False)])
def test_sharded_meshes_refuse_the_elastic_width_as_jax(mesh_shape, fsdp):
    kw = dict(batch_size=32, mesh_shape=mesh_shape, fsdp=fsdp,
              elastic_width=4)
    with pytest.raises(ValueError) as want:
        JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
                   JaxConfig(num_devices=4 if "," in mesh_shape else 2, **kw),
                   metrics=JaxMetrics(echo=False))
    with pytest.raises(ValueError) as got:
        check_supported(Config(**kw))
    assert str(got.value) == str(want.value)

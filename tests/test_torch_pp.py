"""The port's pipeline parallelism (`parallel/pp.py`) against the JAX
trainer's GPipe schedule on the CPU.

At world 2: pipe:2 at the default 2 microbatches and at 4, with
momentum and the global-norm clip at 0.05 (where it binds), and
lenet5_relu (whose stage boundary falls after a pool). At world 4:
pipe:2,data:2, on the per-batch route with --augment shift (the
reference's microbatch rows and (step, data index) keys),
pipe:2,data:2 --fsdp, and FSDP x PP under the clip. Each as
tests/torch_mesh_parity.py sets out: first gradients, params, losses,
eval, and the reference's packed-row checkpoints both ways. The plan's
host decisions (the stage split, the stage input shapes, a_max and
p_max) equal the reference's, `pack_params` its rows bit for bit, and
the pipe meshes refuse what the reference's trainer refuses, in its
words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.parallel.pp import make_pipeline_plan as jax_plan
from mpi_cuda_cnn_tpu.parallel.pp import pack_params as jax_pack
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.pp import (
    make_pipeline_plan,
    microbatch_rows,
    pack_params,
    unpack_params,
)
from mpi_cuda_cnn_tpu_torch.utils.config import Config, check_supported
from torch_mesh_parity import (
    STEPS,
    Case,
    assert_case,
    jax_run,
    port_runs,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CLIP = (("momentum", 0.9), ("grad_clip", 0.05))
CASES = {2: [Case("reference_cnn", "pipe:2"),
             Case("reference_cnn", "pipe:2", (("num_microbatches", 4),)),
             Case("reference_cnn", "pipe:2", CLIP),
             Case("lenet5_relu", "pipe:2")],
         4: [Case("reference_cnn", "pipe:2,data:2"),
             Case("reference_cnn", "pipe:2,data:2",
                  (("scan", False), ("augment", "shift"))),
             Case("reference_cnn", "pipe:2,data:2", (("fsdp", True),)),
             Case("reference_cnn", "pipe:2,data:2", (("fsdp", True),) + CLIP)]}
ALL = [c for cases in CASES.values() for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    want = {c.id: jax_run(c, tmp / f"jax-{c.id}") for c in ALL}
    port = {}
    for cases in CASES.values():
        port.update(port_runs(cases, want, tmp))
    return tmp, want, port


@pytest.mark.parametrize("case", ALL, ids=[c.id for c in ALL])
def test_pp_matches_the_jax_trainer(runs, case):
    tmp, want, port = runs
    assert_case(case, port[case.id], want[case.id], tmp)


@pytest.mark.parametrize("case", [ALL[1], ALL[4], ALL[6]],
                         ids=[c.id for c in (ALL[1], ALL[4], ALL[6])])
def test_pp_collectives_are_the_schedules(runs, case):
    """Per step and microbatch one send and one receive a boundary; per
    step one mean over the data line (a reduce-scatter under FSDP x PP,
    after its one gather), one sum of the metrics over the world and one
    of the preemption flags (every step ends a chunk at log_every 1)."""
    _, _, port = runs
    m = dict(case.flags).get("num_microbatches", 2)
    fsdp = dict(case.flags).get("fsdp", False)
    data = "data" in case.mesh
    for res in port[case.id][0]:
        coll = res["epoch_counts"]["collectives"]
        assert coll.get("send", 0) == STEPS * m
        assert coll.get("recv", 0) == STEPS * m
        assert coll["all_reduce"] == STEPS * (2 + (data and not fsdp))
        assert coll.get("reduce_scatter", 0) == STEPS * fsdp
        assert coll.get("all_gather", 0) == STEPS * fsdp


def _jax_params(name):
    model = JAX_PRESETS[name]()
    key = jax.random.key(3)
    return model.init(key, lambda k, s, dtype=jnp.float32:
                      jax.random.normal(k, s, dtype))


@pytest.mark.parametrize("n_model,fsdp", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("name", ["reference_cnn", "lenet5_relu", "lenet5"])
def test_plan_and_packed_rows_are_the_references(name, stages, n_model,
                                                 fsdp):
    jplan = jax_plan(JAX_PRESETS[name](), stages, n_model=n_model,
                     fsdp_degree=fsdp)
    plan = make_pipeline_plan(get_model(name), stages, n_model=n_model,
                              fsdp_degree=fsdp)
    assert plan.stage_layers == jplan.stage_layers
    assert plan.stage_in_shapes == jplan.stage_in_shapes
    assert plan.param_shapes == jplan.param_shapes
    assert (plan.a_max, plan.p_max) == (jplan.a_max, jplan.p_max)
    assert plan.layer_sliced == jplan.layer_sliced
    jparams = jax.device_get(_jax_params(name))
    params = params_from_jax(jparams)
    packed = pack_params(plan, params)
    np.testing.assert_array_equal(packed, np.asarray(jax_pack(jplan,
                                                              jparams)))
    back = unpack_params(plan, packed, params)
    for a, b in zip(tree_leaves(back), tree_leaves(params), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n,m,n_data", [(32, 2, 1), (32, 4, 2), (32, 2, 4)])
def test_microbatch_rows_are_the_reference_placement(eight_devices, n, m,
                                                     n_data):
    """The reference's per-batch route splits the batch into m
    microbatches, then each over the data axis (P(None, 'data'))."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh({"data": n_data}, devices=eight_devices[:n_data])
    arr = jax.device_put(np.arange(n).reshape(m, n // m),
                         NamedSharding(mesh, P(None, "data")))
    for shard in arr.addressable_shards:
        d = int(np.argwhere(np.asarray(mesh.devices) == shard.device)[0][0])
        np.testing.assert_array_equal(
            np.asarray(shard.data).reshape(-1),
            microbatch_rows(n, m, n_data, d))


@pytest.mark.parametrize("kw", [
    dict(mesh_shape="data:2", num_microbatches=2),
    dict(mesh_shape="pipe:2", grad_accum=2),
    dict(mesh_shape="pipe:2", param_dtype="bfloat16"),
    dict(mesh_shape="pipe:2", fsdp=True),
    dict(mesh_shape="pipe:2", num_microbatches=3),
    dict(mesh_shape="pipe:2,data:2", num_microbatches=32)],
    ids=["microbatches-without-pipe", "grad-accum", "bf16-params",
         "fsdp-without-data", "batch-3", "batch-64"])
def test_pipe_refusals_are_the_references_words(kw):
    n = 4 if "," in kw["mesh_shape"] else 2
    with pytest.raises(ValueError) as want:
        JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
                   JaxConfig(batch_size=32, num_devices=n, **kw),
                   metrics=JaxMetrics(echo=False))
    with pytest.raises(ValueError) as got:
        check_supported(Config(batch_size=32, **kw))
    assert str(got.value) == str(want.value)

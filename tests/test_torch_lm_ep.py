"""The port's expert parallelism (`parallel/ep.py`, `parallel/moe.py`
`moe_mlp` with `axis`) against the JAX trainer's on the CPU, as
tests/torch_lm_mesh_parity.py sets out: EP x DP (expert:2 top-1,
data:2,expert:2 top-2, expert:2 with --grad-accum 2; each rank routes
its own tokens, the slots all-to-all'd over 'expert') and EP x SP (MoE
under seq:2 and data:2,seq:2, the experts parallel over 'seq'). Also
the standalone EP layer against the JAX `make_moe_layer`, and the
reference's refusals of the expert axis.
"""

import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig, check_lm_supported
from torch_lm_mesh_parity import MOE, Case, assert_case, run_world
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("expert:2", (("moe_experts", 4),), sample=True),
         Case("expert:2", MOE + (("grad_accum", 2),)),
         Case("seq:2", MOE),
         Case("data:2,expert:2", MOE + (("pos", "rope"),)),
         Case("data:2,seq:2", (("moe_experts", 4), ("kv_heads", 2)))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_ep")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_ep_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


def _layer_rank(mesh, params, x, top_k):
    import torch

    from mpi_cuda_cnn_tpu_torch.parallel.ep import make_moe_layer

    layer = make_moe_layer(mesh, n_experts=4, top_k=top_k)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    n = len(x) // mesh.world
    y, aux = layer(params, torch.from_numpy(x[mesh.rank * n:
                                               (mesh.rank + 1) * n]))
    return y.numpy(), float(aux)


@pytest.mark.parametrize("top_k", [1, 2])
def test_the_ep_layer_matches_the_jax_layer(top_k):
    import jax

    from mpi_cuda_cnn_tpu.parallel.ep import init_moe_params
    from mpi_cuda_cnn_tpu.parallel.ep import make_moe_layer as jax_layer
    from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh

    params = jax.device_get(init_moe_params(jax.random.key(1), 8, 32, 4))
    x = np.asarray(jax.random.normal(jax.random.key(2), (64, 8)),
                   np.float32)
    mesh = make_mesh({"expert": 2}, devices=jax.devices()[:2])
    want_y, want_aux = jax_layer(mesh, n_experts=4, top_k=top_k)(params, x)
    ranks = run_ranks(_layer_rank, 2, args=(
        {k: np.asarray(v) for k, v in params.items()}, x, top_k),
        axes={"expert": 2}, timeout=120)
    y = np.concatenate([r[0] for r in ranks])
    np.testing.assert_allclose(y, np.asarray(want_y), rtol=1e-5, atol=1e-6)
    for _, aux in ranks:
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("flags,match", [
    (dict(mesh_shape="expert:2,seq:2", moe_experts=4),
     "an 'expert' mesh axis composes with 'data' only"),
    (dict(mesh_shape="expert:2"), "an 'expert' mesh axis needs an MoE model"),
    (dict(mesh_shape="expert:4", moe_experts=6, batch_size=8),
     "experts 6 not divisible by expert-axis size 4"),
    (dict(mesh_shape="data:2,expert:2", moe_experts=4, batch_size=6),
     r"batch_size 6 not divisible by data x expert shards \(2 x 2\)"),
    (dict(mesh_shape="expert:2", moe_experts=4, moe_dispatch_chunk=8),
     "--moe-dispatch-chunk is the SINGLE-DEVICE")],
    ids=["with_seq", "dense", "experts", "batch", "chunk"])
def test_what_the_expert_axis_refuses(flags, match):
    with pytest.raises(ValueError, match=match):
        check_lm_supported(LMConfig(**flags))

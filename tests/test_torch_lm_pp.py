"""The port's LM pipeline (`parallel/lm_shard.py` on the GPipe schedule
of `parallel/pp.py`, `parallel/pp_lm.py`) against the JAX trainer's
(`parallel/pp_lm.py`) on the CPU, as tests/torch_lm_mesh_parity.py sets
out: pipe:2 (M = 2 microbatches; dense, rope with the in-step clip, and
MoE with each stage's tokens routed by themselves), pipe:2,data:2 and
SP x PP (pipe:2,seq:2, ring attention in each stage). Also the stacked
checkpoint tree and the microbatch rows.
"""

import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh
from mpi_cuda_cnn_tpu_torch.parallel.pp_lm import (
    pp_lm_shard_batch,
    stack_blocks,
    unstack_blocks,
)
from torch_lm_mesh_parity import MOE, Case, assert_case, run_world
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("pipe:2", sample=True),
         Case("pipe:2", (("pos", "rope"), ("grad_clip", 0.05))),
         Case("pipe:2", MOE),
         Case("pipe:2,data:2", (("kv_heads", 2),)),
         Case("pipe:2,seq:2")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_pp")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_pp_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


def test_stack_blocks_round_trips_and_matches_jax():
    import jax

    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
    from mpi_cuda_cnn_tpu.parallel.pp_lm import stack_blocks as jax_stack
    from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves

    params = jax.device_get(JaxLM(vocab=16, dim=8, heads=2, depth=4,
                                  max_seq=8).init(jax.random.key(0)))
    port = stack_blocks(params_from_jax(params))
    want = jax.tree.leaves(jax_stack(params))
    for a, b in zip(tree_leaves(port), want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = unstack_blocks(port, 4)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(params),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_each_rank_takes_its_microbatch_rows():
    """pipe:2,data:2,seq:2 over 8 ranks: microbatch m's rows m*4 ..
    m*4+3 split over 'data', the positions over 'seq'."""
    tokens = np.arange(8 * 16).reshape(8, 16)
    shape = {"pipe": 2, "data": 2, "seq": 2}
    for rank in range(8):
        mesh = Mesh(shape=shape, rank=rank, world=8, device=None,
                    group=None)
        d, s = mesh.index("data"), mesh.index("seq")
        rows = [m * 4 + d * 2 + i for m in range(2) for i in range(2)]
        np.testing.assert_array_equal(pp_lm_shard_batch(tokens, mesh, 2),
                                      tokens[rows][:, 8 * s:8 * s + 8])

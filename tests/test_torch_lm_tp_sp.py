"""The port's TP x SP LM (`parallel/lm_shard.py` with the Megatron block
of `parallel/tp_sp.py` and the attentions of `parallel/sp.py` on the
local heads) against the JAX trainer's (`parallel/tp_sp.py`) on the
CPU, as tests/torch_lm_mesh_parity.py sets out: model:2,seq:2 with ring
(MHA; GQA with rope and the in-step clip; MoE, each rank's tokens routed
by themselves, TP inside every expert) and with Ulysses, and
data:2,model:2,seq:2 over 8 ranks. The checkpoint holds the
head-structured blocks; the layouts round-trip bit for bit.
"""

import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.parallel.tp_sp import from_tp_layout, to_tp_layout
from torch_lm_mesh_parity import MOE, Case, assert_case, run_world
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("model:2,seq:2", sample=True),
         Case("model:2,seq:2", (("kv_heads", 2), ("pos", "rope"),
                                ("grad_clip", 0.05))),
         Case("model:2,seq:2", MOE),
         Case("model:2,seq:2", (("attn_impl", "ulysses"),)),
         Case("data:2,model:2,seq:2")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp_sp")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_tp_sp_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


@pytest.mark.parametrize("kv", [4, 2])
def test_tp_layout_matches_jax_and_round_trips(kv):
    import jax

    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
    from mpi_cuda_cnn_tpu.parallel.tp_sp import to_tp_layout as jax_layout
    from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM

    cfg = dict(vocab=16, dim=16, heads=4, kv_heads=kv, depth=2, max_seq=8)
    params = jax.device_get(JaxLM(**cfg).init(jax.random.key(0)))
    model = TransformerLM(**cfg)
    port = to_tp_layout(params_from_jax(params), model)
    for a, b in zip(tree_leaves(port), jax.tree.leaves(
            jax_layout(params, JaxLM(**cfg))), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(from_tp_layout(port, model)),
                    jax.tree.leaves(params), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

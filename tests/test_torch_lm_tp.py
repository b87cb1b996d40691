"""The port's LM tensor parallelism (`parallel/lm_shard.py` with the
Megatron block of `parallel/tp_sp.py`) against the JAX trainer's GSPMD
TP (`parallel/tp.py` `lm_tp_specs` placing the plain step) on the CPU,
as tests/torch_lm_mesh_parity.py sets out: first gradients, per-step
losses, params, eval and checkpoints both ways.

data:2,model:2 (MHA, the embedding and head split on the vocab when the
axis divides it), model:2 with GQA (4 over 2 heads: one KV head a rank),
model:2 with MQA and rope (the axis does not divide the one KV head, so
attention stays whole on every rank, the GSPMD fallback), MoE
(4 experts, top-2, routed over the data line as one batch, TP inside
every expert), --grad-clip and --grad-accum. Also the specs: which
leaves 'model' splits, and the --decode-weights-dtype refusal under a
model axis.
"""

import pytest

from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.parallel.lm_shard import ShardedLM
from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh
from torch_lm_mesh_parity import MOE, Case, assert_case, run_world
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CASES = [Case("data:2,model:2", sample=True),
         Case("data:2,model:2", MOE),
         Case("data:2,model:2", (("grad_clip", 0.05), ("grad_accum", 2))),
         Case("model:2", (("kv_heads", 2),)),
         Case("model:2", (("kv_heads", 1), ("pos", "rope")))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_tp_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


@pytest.mark.parametrize("kv,attn", [(4, True), (2, True), (1, False)])
def test_what_the_model_axis_splits(kv, attn):
    """Attention is split by heads when the axis divides both head
    counts, else whole; the MLP on its hidden; the vocab-split embedding
    and head only where the axis divides the vocab."""
    model = TransformerLM(vocab=64, dim=32, heads=4, kv_heads=kv, depth=1,
                          max_seq=64)
    mesh = Mesh(shape={"data": 1, "model": 2}, rank=0, world=2,
                device="cpu", group=None)
    shard = ShardedLM(model, mesh, attn_impl="oracle")
    assert (shard.attn_sliced, shard.mlp_sliced) == (attn, True)
    assert shard.ckpt_form == "standard"

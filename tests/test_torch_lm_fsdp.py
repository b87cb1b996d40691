"""The port's LM FSDP (`parallel/lm_shard.py`: each leaf blocked over
'data' by `parallel/fsdp.py`'s rule, gathered before the forward in one
all-gather and its gradient reduce-scattered) against the JAX trainer's
on the CPU, as tests/torch_lm_mesh_parity.py sets out: data:2 --fsdp
(dense and MoE, routed over the data line as one batch), FSDP x TP
(data:2,model:2, GQA and rope) and FSDP x SP (data:2,seq:2, ring, with
the in-step clip over the world).
"""

import pytest

from torch_lm_mesh_parity import MOE, Case, assert_case, run_world
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

FSDP = (("fsdp", True),)
CASES = [Case("data:2", FSDP, sample=True),
         Case("data:2", FSDP + MOE),
         Case("data:2,model:2", FSDP + (("kv_heads", 2), ("pos", "rope"))),
         Case("data:2,seq:2", FSDP + (("grad_clip", 0.05),))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_fsdp")
    out = {}
    for world in sorted({c.world for c in CASES}):
        want, port = run_world([c for c in CASES if c.world == world], tmp)
        out.update({k: (want[k], port[k]) for k in want})
    return tmp, out


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lm_fsdp_matches_the_jax_trainer(runs, case):
    tmp, out = runs
    want, port = out[case.id]
    assert_case(case, port, want, tmp)


def test_fsdp_collectives_a_step(runs):
    """data:2 --fsdp: per step one all-gather of the blocks and one
    reduce-scatter of the gradients, and one all-reduce of the
    preemption flags."""
    _, out = runs
    _, (ranks, _) = out[CASES[0].id]
    for res in ranks:
        coll = res["counts"]["collectives"]
        steps = 3
        assert coll["all_gather"] == steps
        assert coll["reduce_scatter"] == steps

"""Tensor parallelism inside the LM's pipeline stages, over a ('pipe',
'model' [, 'seq'] [, 'data']) mesh (counterpart of the reference's
`parallel/tp_pp_lm.py`).

Each stage's blocks are the Megatron block of `parallel/tp_sp.py` on the
rank's heads and hidden slice, and the GPipe schedule is the LM
pipeline's (`parallel/pp_lm.py`, `parallel/lm_shard.py`): the model
ranks of a stage run it identically on replicated activations, each
sending to the rank of the next stage with its model coordinate. With a
'seq' axis too this is the full 4D mesh (pipe x model x seq x data):
each stage's attention is the ring (or ring-flash) over 'seq' on the
local heads. The checkpoint holds the reference's packed form: stacked
head-structured blocks and the replicated rest (`ShardedLM.to_ckpt`).
"""

from __future__ import annotations

from .pp_lm import _check_pp_lm
from .tp_sp import _check_tp_sp


def _check_tp_pp(model, n_pipe: int, n_tp: int) -> None:
    """The reference's checks of a TP x PP mesh: the pipe axis divides
    the depth, the model axis the heads, kv heads and MLP hidden."""
    _check_pp_lm(model, n_pipe)
    _check_tp_sp(model, n_tp)

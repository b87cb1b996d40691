"""Parallelism: the data mesh, data-parallel training, process groups
(counterpart of the reference's `parallel/`).

The C reference's distributed layer is raw MPI inlined in main()
(MPI_Init/Comm_rank/Comm_size/Allreduce/Finalize, cnnmpi.c:419-422,490,
558), with a blocking all-reduce per sample and per layer. Here, as in
the JAX package, a step makes ONE gradient all-reduce, over
`torch.distributed` with one process per rank. Every family is ported:
data (`dp.py`, `elastic.py`), tensor (`tp.py`, `tp_sp.py`), fully
sharded (`fsdp.py`), pipeline (`pp.py`, `pp_lm.py`, `tp_pp_lm.py`),
sequence (`sp.py`) and expert (`ep.py`, `moe.py`) parallelism, the LM's
sharded meshes one rank at a time in `lm_shard.py`.
"""

from .distributed import initialize_distributed, process_info, run_ranks
from .dp import dp_shard_batch, make_dp_train_step, replicate
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, local_device_count, make_mesh

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "make_mesh",
    "local_device_count",
    "dp_shard_batch",
    "make_dp_train_step",
    "replicate",
    "initialize_distributed",
    "process_info",
    "run_ranks",
]

"""Parallelism: the data mesh, data-parallel training, process groups
(counterpart of the reference's `parallel/`).

The C reference's distributed layer is raw MPI inlined in main()
(MPI_Init/Comm_rank/Comm_size/Allreduce/Finalize, cnnmpi.c:419-422,490,
558), with a blocking all-reduce per sample and per layer. Here, as in
the JAX package, a step makes ONE gradient all-reduce, over
`torch.distributed` with one process per rank. Only the data axis is
ported; the pipeline, tensor, sequence and expert families are not
(ROADMAP queue A).
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

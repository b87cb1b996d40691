"""PyTorch + CUDA port of mpi_cuda_cnn_tpu, for one NVIDIA H100.

The JAX package `mpi_cuda_cnn_tpu` stays beside this one as the
reference. This package imports `torch` and `numpy` and never `jax` or
anything of the JAX package; module names mirror the reference so each
counterpart is easy to find. Two slices so far, with hand-written CUDA
kernels whose sources are under `csrc/`:

- the paged continuous-batching serving path: `serve/engine.PagedEngine`,
  driven by `python -m mpi_cuda_cnn_tpu_torch serve-bench`, with kernels
  for the paged-attention read (`ops/paged_attention.py`) and the int8
  weight matmul (`ops/gemv.py`);
- CNN training on one device: `train/trainer.Trainer`, driven by
  `python -m mpi_cuda_cnn_tpu_torch train` and `train-bench`, with
  kernels for the FC products, the direct conv and its input gradient,
  and the conv weight gradient (`ops/kernel_ops.py`).

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); on the CPU every kernel wrapper uses
its plain PyTorch version.
"""

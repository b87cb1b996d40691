"""Command line of the port: `python -m mpi_cuda_cnn_tpu_torch <command>`.

    serve-bench   the paged continuous-batching serving bench
                  (serve/bench.py; --device cpu to run on the CPU)
"""

from __future__ import annotations

import sys

_USAGE = "usage: python -m mpi_cuda_cnn_tpu_torch serve-bench [flags]"


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve-bench":
        from .serve.bench import serve_bench_main

        return serve_bench_main(argv[1:])
    print(_USAGE, file=sys.stderr)
    return 2

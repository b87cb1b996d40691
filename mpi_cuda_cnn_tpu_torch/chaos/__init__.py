"""Seeded fault-schedule search over the fleet storm: `python -m
mpi_cuda_cnn_tpu_torch chaos` (counterpart of the reference's `chaos/`
package, the same code and output).

Three torch-free pieces: a plan sampler over the live `faults.SITES`
registry (`sampler`), a deterministic episode harness with a global
invariant oracle (`episode`), and a ddmin plan minimizer (`shrink`).
`cli.chaos_main` drives all three.
"""

from .episode import EpisodeConfig, EpisodeResult, config_for, run_episode
from .sampler import (
    RAISING_KINDS,
    SURFACE,
    EpisodeAxes,
    sample_axes,
    sample_plan,
)
from .shrink import shrink

__all__ = [
    "RAISING_KINDS",
    "SURFACE",
    "EpisodeAxes",
    "EpisodeConfig",
    "EpisodeResult",
    "config_for",
    "run_episode",
    "sample_axes",
    "sample_plan",
    "shrink",
]

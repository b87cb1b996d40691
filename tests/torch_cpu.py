"""Imported by every tests/test_torch_*.py: torch runs its CPU ops on one
intra-op thread in the test processes.

The suite runs under pytest-xdist, six workers at once on the machine's
cores; with torch's default of a thread per core each worker
oversubscribes them, and its float32 ops wait on one another (twelve of
these files took 294 s of wall with the default and 117 s with one
thread, six workers on eight cores). Spawned ranks already run one
thread (`parallel/distributed.py`). Every worker imports every test
module when it collects, so this holds for the whole run.
"""

import torch

torch.set_num_threads(1)

"""Torch's intra-op threads for the port's CPU tests.

The suite runs in six pytest-xdist workers on an eight-core CPU, and
torch's default pool (a thread a core) in each worker oversubscribes the
cores: six parallel runs of one tiny Stage-3 trainer test took 810 s
there, 110 s with two threads a process (82 s for one run alone). Each
port test file imports this module; subprocesses that the tests start get
``OMP_NUM_THREADS`` = ``THREADS`` in their environment.
"""

import torch

THREADS = 2
torch.set_num_threads(THREADS)

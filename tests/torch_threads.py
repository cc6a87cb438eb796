"""One torch intra-op thread per test process.

The suite runs as several pytest-xdist workers on one host.  torch's
default pool of one thread a core in each of them oversubscribes the
cores, and the port's CPU tests, mostly small ops, then spend most of
their time waiting for each other's threads: beside five other workers
the trainer's 30-step case took 154 s against 2 s alone.  Every
``tests/test_torch_*.py`` module that runs on the CPU imports this one, so
a worker that collects any of them runs torch on one thread.
"""
import torch

torch.set_num_threads(1)

"""Caps PyTorch's intra-op threads for the port's CPU tests.

Imported by the ``tests/test_torch_*.py`` files.  Under pytest-xdist every
worker process would start one intra-op thread per CPU, so six workers on
eight CPUs run ~48 threads, and the port's many small tensor ops slow down
several-fold.  Each worker takes its share of the CPUs instead (all of them
when the tests run in one process).
"""

import os

import torch

_WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1') or 1)
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

"""Imported by the ``tests/test_torch_*.py`` modules for its one effect.

The test workers share the machine's cores: one intra-op thread per worker
keeps torch from oversubscribing them.  This is a speed setting only (it
shortens the port's tests under ``-n 6``); it is process-wide, so it also
holds for the other files a worker runs.
"""
import torch

torch.set_num_threads(1)

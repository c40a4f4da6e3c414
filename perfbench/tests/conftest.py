"""Few threads a test process: the tests run in several processes at once, and torch's
threads, one a core in each, would wait on each other."""

import torch

torch.set_num_threads(min(2, torch.get_num_threads()))

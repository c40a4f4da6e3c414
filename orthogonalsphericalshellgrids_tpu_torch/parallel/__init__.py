"""Y-partitioned distributed runs (``parallel/distributed.py``) and the layouts of the
models' tensors (``parallel/layouts.py``)."""

from . import distributed, layouts
from .distributed import (LocalExchange, ProcessGroupExchange, ShardedStep, Spmd,
                          distribute, distribute_layered, gather_layered_state,
                          gather_state, make_mesh, run_steps, sharded_layered_step_fn,
                          sharded_step_fn, spawn)

"""Y-partitioned (1-D) and (x, y)-partitioned (2-D) distributed runs
(``parallel/distributed.py``, ``parallel/distributed2d.py``) and the layouts of the
models' tensors (``parallel/layouts.py``)."""

from . import distributed, distributed2d, layouts
from .distributed import (LocalExchange, ProcessGroupExchange, ShardedStep, Spmd,
                          distribute, distribute_layered, gather_layered_state,
                          gather_state, make_mesh, run_steps, sharded_layered_step_fn,
                          sharded_step_fn, spawn)
from .distributed2d import (distribute2d, distribute_layered2d, gather_layered_state2d,
                            gather_state2d, make_mesh2d, sharded_layered_step_fn2d,
                            sharded_step_fn2d)

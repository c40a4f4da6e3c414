from . import hydrostatic, split_explicit
from .hydrostatic import (HydrostaticModel, State, compute_cfl_dt, from_jax_arrays,
                          initial_state, make_model, multi_step, state_from_numpy, step,
                          tendencies, vorticity)
from .split_explicit import SplitExplicitFreeSurface, averaging_weights

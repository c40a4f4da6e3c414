from . import ensemble, hydrostatic, layered, split_explicit
from .ensemble import ensemble_multi_step, ensemble_step, member, stack_members
from .hydrostatic import (HydrostaticModel, State, compute_cfl_dt, from_jax_arrays,
                          initial_state, make_model, multi_step, state_from_numpy, step,
                          tendencies, vorticity)
from .split_explicit import SplitExplicitFreeSurface, averaging_weights
from .layered import (LayeredModel, LayeredState, layered_cfl_dt, layered_from_jax_arrays,
                      layered_initial_state, layered_multi_step, layered_state_from_numpy,
                      layered_step, layered_tendencies, make_layered_model)

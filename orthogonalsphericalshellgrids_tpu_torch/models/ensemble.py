"""Ensembles of the single-layer and the layered model: B members stepped together.

Counterpart: ``jax.vmap(step)`` and ``jax.vmap(layered_step)`` over a batch of states
(``tests/test_ensemble.py`` of the JAX package; on the TPU, ``pallas_call``'s batching
rule gives the kernels a batch axis). ``torch.func.vmap`` cannot see through the
kernels' launches, so the member axis is written out: an ensemble is a ``State`` or a
``LayeredState`` whose fields carry a leading axis B, with (B,) ``t`` and
``iteration``, and it goes through ``models/hydrostatic.py:step`` or
``models/layered.py:layered_step``'s own code. One step launches each kernel as often
as one serial step does, for all members:

- single-layer: the state group and GU/GV fills take the member stacks as planes,
  the momentum kernel loops over them as layers (its closure pack repeating every
  layer), the tracer kernel runs its member mode (``tracer_adv_members``) and the
  barotropic kernel a member axis of its grid;
- layered: the fills likewise; the vertical, corrector and layered tracer kernels
  take the members as their grid's z index (``vertical_members``,
  ``corrector_members``, ``tracer_adv_layered_members``), the momentum kernel runs
  the B·Nz layers with its closure pack and closing mask repeating every Nz
  (``momentum_members``), and the barotropic kernel its member axis.

The model, and so the grid, the masks and Δt, is shared; each member keeps its own
time and iteration, so its first step is forward Euler and the later ones AB2
whatever the other members do.

Each member's step is its serial step's arithmetic, so on the card and on the CPU a
member of an ensemble run is bitwise its own serial run.

A batch also runs sharded, the counterpart of ``jax.vmap(sharded_step_fn(mesh,
dist_model))``: ``parallel``'s ``distribute`` / ``distribute_layered`` (and their 2-D
forms) cut it into its ranks' batches as they cut one state, ``sharded_step_fn`` /
``sharded_layered_step_fn`` step them (each rank's ``step`` or ``layered_step`` takes
the member axis, the overlap split included), ``gather_state`` returns the batch and
``member`` reads a member from it. The fills, packs and exchanges carry the members
as planes, so a step exchanges as often as one member's would; each member is bitwise
its own sharded run.
"""

from __future__ import annotations

import dataclasses

import torch

from .hydrostatic import HydrostaticModel, State, compute_cfl_dt, step
from .layered import LayeredModel, LayeredState, layered_cfl_dt, layered_step

__all__ = ["stack_members", "member", "ensemble_step", "ensemble_multi_step",
           "compute_cfl_dt", "layered_cfl_dt"]


def _fields(state):
    return [f.name for f in dataclasses.fields(state)]


def stack_members(states):
    """One ensemble ``State`` or ``LayeredState`` from a sequence of B serial states of
    one model: every field stacked on a new leading axis, ``t`` and ``iteration`` as
    (B,) tensors."""
    states = list(states)
    if not states:
        raise ValueError("an ensemble needs at least one member")
    if any(s.t.dim() != 0 for s in states):
        raise ValueError("stack_members takes serial states (0-d t and iteration)")
    kind = type(states[0])
    if any(type(s) is not kind for s in states):
        raise ValueError("stack_members takes states of one kind")
    return kind(**{name: torch.stack([getattr(s, name) for s in states])
                   for name in _fields(kind)})


def member(batch, i: int):
    """Member ``i`` of an ensemble as a serial state of the batch's kind (views of the
    batch)."""
    _check_batch(batch)
    return type(batch)(**{name: getattr(batch, name)[i] for name in _fields(batch)})


def _check_batch(batch):
    if batch.t.dim() != 1:
        raise ValueError(f"an ensemble state has (B,) t and iteration, got t of shape "
                         f"{tuple(batch.t.shape)}")


def _stepper(model, batch, dt):
    """The step of ``model``'s kind, after the checks of an ensemble."""
    if isinstance(model, HydrostaticModel) and isinstance(batch, State):
        fn = step
    elif isinstance(model, LayeredModel) and isinstance(batch, LayeredState):
        fn = layered_step
    else:
        raise TypeError(f"an ensemble of {type(model).__name__} takes its own state "
                        f"kind, got {type(batch).__name__}")
    _check_batch(batch)
    if torch.is_tensor(dt) and dt.dim() != 0:
        raise ValueError("the members of an ensemble share one dt (a number or a 0-d "
                         "tensor); take the minimum of compute_cfl_dt's")
    return fn


def ensemble_step(model, batch, dt):
    """One time step of every member (``models/hydrostatic.py:step`` on a
    ``HydrostaticModel``'s batch, ``models/layered.py:layered_step`` on a
    ``LayeredModel``'s), serial; a sharded batch steps through ``parallel``'s
    sharded step functions."""
    return _stepper(model, batch, dt)(model, batch, dt)


def ensemble_multi_step(model, batch, dt, n_steps: int):
    """``n_steps`` time steps of every member at a fixed ``dt``: the eager loop on the
    CPU, replays of the model's captured CUDA graphs of the step on a card
    (``utils/graph.py``; the member count is part of the graphs' layout), bitwise equal
    to the loop."""
    from ..utils import graph

    return graph.run(_stepper(model, batch, dt), model, batch, dt, n_steps)

"""Ensembles of the single-layer model: B members stepped together.

Counterpart: ``jax.vmap(step)`` over a batch of states (``tests/test_ensemble.py`` of
the JAX package; on the TPU, ``pallas_call``'s batching rule gives the fill and
barotropic kernels a batch axis). ``torch.func.vmap`` cannot see through the
kernels' launches, so the member axis is written out: an ensemble is a ``State``
whose fields carry a leading axis B, with (B,) ``t`` and ``iteration``, and it goes
through ``models/hydrostatic.py:step``'s own code. One step launches each kernel as
often as one serial step does, for all members: the state group and GU/GV fills take
the member stacks as planes, the momentum kernel loops over them as layers, the
tracer kernel runs its member mode (``tracer_adv_members``) and the barotropic
kernel a member axis of its grid. The model, and so the grid, the masks and Δt, is
shared; each member keeps its own time and iteration, so its first step is forward
Euler and the later ones AB2 whatever the other members do.

Each member's step is its serial step's arithmetic, so on the card and on the CPU a
member of an ensemble run is bitwise its own serial run.
"""

from __future__ import annotations

import dataclasses

import torch

from .hydrostatic import HydrostaticModel, State, compute_cfl_dt, step

__all__ = ["stack_members", "member", "ensemble_step", "ensemble_multi_step",
           "compute_cfl_dt"]


def stack_members(states) -> State:
    """One ensemble ``State`` from a sequence of B serial states of one model: every
    field stacked on a new leading axis, ``t`` and ``iteration`` as (B,) tensors."""
    states = list(states)
    if not states:
        raise ValueError("an ensemble needs at least one member")
    if any(s.t.dim() != 0 for s in states):
        raise ValueError("stack_members takes serial states (0-d t and iteration)")
    return State(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                    for f in dataclasses.fields(State)})


def member(batch: State, i: int) -> State:
    """Member ``i`` of an ensemble as a serial ``State`` (views of the batch)."""
    _check_batch(batch)
    return State(**{f.name: getattr(batch, f.name)[i] for f in dataclasses.fields(State)})


def _check_batch(batch):
    if batch.t.dim() != 1:
        raise ValueError(f"an ensemble state has (B,) t and iteration, got t of shape "
                         f"{tuple(batch.t.shape)}")


def _check(model, batch, dt):
    if not isinstance(model, HydrostaticModel):
        raise NotImplementedError(
            f"ensembles of {type(model).__name__} are not ported (ROADMAP queue 1: "
            f"ensembles of the layered model)")
    _check_batch(batch)
    if torch.is_tensor(dt) and dt.dim() != 0:
        raise ValueError("the members of an ensemble share one dt (a number or a 0-d "
                         "tensor); take the minimum of compute_cfl_dt's")


def ensemble_step(model: HydrostaticModel, batch: State, dt) -> State:
    """One time step of every member (``models/hydrostatic.py:step`` on the batch,
    which refuses a sharded ensemble)."""
    _check(model, batch, dt)
    return step(model, batch, dt)


def ensemble_multi_step(model: HydrostaticModel, batch: State, dt, n_steps: int) -> State:
    """``n_steps`` time steps of every member at a fixed ``dt``."""
    _check(model, batch, dt)
    for _ in range(n_steps):
        batch = step(model, batch, dt)
    return batch

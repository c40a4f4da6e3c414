"""The single-layer model (``models/hydrostatic.py``), built through the port's API as
``examples/bickley_jet_torch.py:build`` builds it, and its plain reference
(``perfbench/reference/model.py``).

``FIELDS`` are the state's fields that the check compares, ``WIDE`` those that live
on the free surface's widened grid.
"""

FIELDS = ("u", "v", "eta", "U", "V", "c")
WIDE = ("eta", "U", "V")


def reference():
    """The reference's module: ``build``, ``initial_state``, ``run``."""
    from perfbench.reference import model

    return model


def build(cfg, inp, device, mark):
    """(model, state) of configuration ``cfg`` with the inputs ``inp`` on ``device``;
    ``mark(name)`` after the grid, the model and the initial state."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, initial_state, make_model)

    H = cfg["halo"]
    grid = TripolarGrid.make(
        (cfg["nx"], cfg["ny"], 1), halo=(H, H, H), z=(0.0, 1.0),
        first_pole_longitude=cfg["first_pole_longitude"],
        north_poles_latitude=cfg["north_poles_latitude"],
        dtype=getattr(torch, cfg["dtype"]), device=device)
    mark("grid")
    phys = cfg["physics"]
    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=cfg["substeps"]),
                       bottom_height=inp["bottom"], coriolis=phys.get("coriolis", False),
                       tracers=tuple(phys["tracers"]), device=device)
    mark("model")
    return model, initial_fields(model, inp)


def initial_fields(model, inp):
    """The initial state of ``model`` from the inputs ``inp`` (one member's)."""
    from orthogonalsphericalshellgrids_tpu_torch.models import initial_state

    init = inp["init"]
    return initial_state(model, u=init["u"], v=init["v"], c=init["c"], eta=init["eta"])

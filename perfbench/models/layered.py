"""The layered model (``models/layered.py``), built through the port's API as
``examples/wind_driven_ts_gyre_torch.py:build`` builds it, and its plain reference
(``perfbench/reference/layered.py``).

The configuration's ``physics`` gives the model's options; the scenario's inputs give
the layer faces (``z_faces``), the bottom, the wind stress and the initial fields: u,
v, T and S of (λ°, φ°, z), η of (λ°, φ°). ``FIELDS`` are the state's fields that the
check compares (``c`` holds T and S, tracer-major), ``WIDE`` those that live on the
free surface's widened grid.
"""

FIELDS = ("u", "v", "eta", "U", "V", "c")
WIDE = ("eta", "U", "V")


def reference():
    """The reference's module: ``build``, ``initial_state``, ``run``."""
    from perfbench.reference import layered

    return layered


def build(cfg, inp, device, mark):
    """(model, state) of configuration ``cfg`` with the inputs ``inp`` on ``device``;
    ``mark(name)`` after the grid, the model and the initial state."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, make_layered_model)

    H = cfg["halo"]
    grid = TripolarGrid.make(
        (cfg["nx"], cfg["ny"], cfg["nz"]), halo=(H, H, H),
        z=tuple(float(z) for z in inp["z_faces"]),
        first_pole_longitude=cfg["first_pole_longitude"],
        north_poles_latitude=cfg["north_poles_latitude"],
        dtype=getattr(torch, cfg["dtype"]), device=device)
    mark("grid")
    phys = cfg["physics"]
    model = make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=cfg["substeps"]),
        bottom_height=inp["bottom"], buoyancy=phys["buoyancy"],
        tracers=tuple(phys["tracers"]), coriolis=phys["coriolis"],
        thermal_expansion=phys["thermal_expansion"],
        haline_contraction=phys["haline_contraction"],
        reference_temperature=phys["reference_temperature"],
        reference_salinity=phys["reference_salinity"], wind_stress=inp["wind"],
        bottom_drag=tuple(phys["bottom_drag"]), nu_h=phys["nu_h"], kappa_h=phys["kappa_h"],
        nu_v=phys["nu_v"], kappa_v=phys["kappa_v"],
        vertical_time_discretization=phys["vertical_time_discretization"], device=device)
    mark("model")
    return model, initial_fields(model, inp)


def initial_fields(model, inp):
    """The initial state of ``model`` from the inputs ``inp``."""
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_initial_state

    init = inp["init"]
    return layered_initial_state(model, u=init["u"], v=init["v"], eta=init["eta"],
                                 c={name: init[name] for name in model.tracer_names})

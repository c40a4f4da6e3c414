"""The program under test: the model that a configuration's ``model`` names, built by
``perfbench/models/<model>.py`` through the port's own API, and the entry point that a
traffic mix names, by its dotted path in the port's package.

The port is imported inside the functions, so that importing this module loads
nothing of it.
"""

from __future__ import annotations

import dataclasses
import importlib

from . import cells

PACKAGE = "orthogonalsphericalshellgrids_tpu_torch"


def kind(cfg):
    """The module of ``cfg``'s model kind: ``build``, ``initial_fields``, ``FIELDS``,
    ``WIDE`` and ``reference()``."""
    return cells.load_module(cells.HERE / "models" / f"{cfg['model']}.py")


def build(cfg, inp, device, mark=None):
    """(model, state) of configuration ``cfg`` with the inputs ``inp``
    (``scenario.inputs``) on ``device``; ``mark(name)``, where given, is called after
    the grid, the model and the initial state."""
    mark = mark or (lambda name: None)
    model, state = kind(cfg).build(cfg, inp, device, mark)
    mark("initial state")
    return model, state


def entry(path):
    """The port's function at the dotted ``path`` below its package, as a mix names it
    (``models.multi_step``, ``models.ensemble.ensemble_multi_step``)."""
    module, _, name = f"{PACKAGE}.{path}".rpartition(".")
    return getattr(importlib.import_module(module), name)


def full_host_state(state):
    """Every field of ``state`` on the host (numpy): what the reference needs to step
    on from it."""
    out = {f.name: getattr(state, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(state)}
    out["iteration"] = int(out["iteration"])
    return out

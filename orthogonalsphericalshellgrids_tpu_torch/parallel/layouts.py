"""The layout of every tensor of the models and states, by name.

Counterpart: ``orthogonalsphericalshellgrids_tpu/parallel/layouts.py``, for the
port's names. Each tensor is tagged ``base`` (the base-halo grid's rows), ``ext`` (the
extended free-surface grid's rows) or ``rep`` (the same on every rank) by its name,
never by its shape; a name the tables do not hold raises, so that a new model tensor
forces a decision on its layout. ``base`` and ``ext`` tensors are halo-inclusive
planes or stacks of planes, ``(..., Ny + 2·Hy, Nx + 2·Hx)``, partitioned along their
row axis; the kernels' packs are stacks of such planes.

``parallel/distributed.py`` slices the tensors that the models' constructors take and
lets the constructors rebuild what they derive (the packs ``mom_pack``, ``adv_pack``,
``baro_pack``, ``ab2``, the wind planes, the layer coefficients), so each shard's
model is built as a serial one is.
"""

from __future__ import annotations

import dataclasses

__all__ = ["BASE", "EXT", "REP", "leaf_layout", "classify_tree", "check_module"]

BASE, EXT, REP = "base", "ext", "rep"

# containers whose tensors inherit a layout (the grids and the immersed boundary)
_CONTAINERS = {"grid": BASE, "grid_ext": EXT, "ib": BASE}
# 1-D grid members, the same on every rank
_REPLICATED_GRID_MEMBERS = {"z_f", "z_c"}

# State and LayeredState
_STATE_FIELDS = {
    "u": BASE, "v": BASE, "c": BASE, "b": BASE,
    "Gu": BASE, "Gv": BASE, "Gc": BASE, "Gb": BASE,
    "eta": EXT, "U": EXT, "V": EXT,
    "t": REP, "iteration": REP,
}

# HydrostaticModel (models/hydrostatic.py: DERIVED, the closure packs and what its
# constructor derives)
_MODEL_FIELDS = {
    "inv_dx_fc": BASE, "inv_dy_cf": BASE, "inv_az_ff": BASE, "inv_vol_c": BASE,
    "f_ff": BASE, "taux": BASE, "tauy": BASE,
    "inv_dx_fc_e": EXT, "inv_dy_cf_e": EXT, "inv_az_cc_e": EXT,
    "dy_fc_e": EXT, "dx_cf_e": EXT,
    "h_u_e": EXT, "h_v_e": EXT, "mask_u_e": EXT, "mask_v_e": EXT,
    "weights": REP, "ab2": REP,
    "mom_lay": BASE, "inv_h_u": BASE, "inv_h_v": BASE,
    "mom_pack": BASE, "adv_pack": BASE, "baro_pack": EXT,
}

# LayeredModel (models/layered.py: BUFFERS, the closure pack, the wet-layer counts and
# what its constructor derives)
_LAYERED_FIELDS = {
    "mask_c3": BASE, "mask_u3": BASE, "mask_v3": BASE, "dzu": BASE, "dzv": BASE,
    "bot_u": BASE, "bot_v": BASE, "mom_static": BASE, "vert_g": BASE, "n_wet": BASE,
    "wind_u": BASE, "wind_v": BASE,
    "dz_t": REP, "dzc_t": REP, "zc3": REP, "vert_coef": REP,
}

_FIELDS = {**_STATE_FIELDS, **_MODEL_FIELDS, **_LAYERED_FIELDS}


def leaf_layout(name: str) -> str:
    """The layout of the tensor at dotted path ``name`` (``"u"``, ``"grid.dx_fc"``,
    ``"baro.grid_ext.dy_cf"``, ``"mask_c3"``). Raises ``KeyError`` for a name the
    tables do not hold."""
    parts = name.split(".")
    if parts[0] == "baro":  # the layered model holds the single-layer one
        parts = parts[1:]
    if len(parts) > 1 and parts[0] in _CONTAINERS:
        return REP if parts[-1] in _REPLICATED_GRID_MEMBERS else _CONTAINERS[parts[0]]
    try:
        return _FIELDS[parts[-1]]
    except KeyError:
        raise KeyError(f"no distributed layout registered for {name!r}; add it to "
                       "parallel/layouts.py") from None


def classify_tree(state):
    """The layout tags of a ``State`` or ``LayeredState``: an instance of the same
    class with each field's tag (``base``, ``ext``, ``rep``) in place of its tensor,
    None where the field is None (the JAX package's tree of tags,
    ``tree_map_with_path`` of ``leaf_layout``)."""
    return type(state)(**{f.name: None if getattr(state, f.name) is None
                          else leaf_layout(f.name) for f in dataclasses.fields(state)})


def check_module(module) -> dict:
    """{name: layout} of every buffer of ``module`` (a model), each checked: a
    ``base`` or ``ext`` buffer has the rows of its grid. Raises ``KeyError`` for an
    unregistered name and ``ValueError`` for a buffer whose rows disagree."""
    grid = module.grid
    rows = {BASE: grid.Ny + 2 * grid.Hy, EXT: module.grid_ext.Ny + 2 * module.grid_ext.Hy}
    tags = {}
    for name, buf in module.named_buffers(remove_duplicate=False):
        tag = leaf_layout(name)
        if tag != REP and (buf.dim() < 2 or buf.shape[-2] != rows[tag]):
            raise ValueError(f"{name} is tagged {tag!r} but has shape "
                             f"{tuple(buf.shape)}; {tag} planes have {rows[tag]} rows")
        tags[name] = tag
    return tags

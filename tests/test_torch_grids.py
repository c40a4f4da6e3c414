"""The PyTorch port's grid modules against the JAX package, at float64 exactly.

Covers grids/geometry, grids/latlon, grids/tripolar (build_tripolar_arrays,
TripolarGrid.make, with_halo), grids/immersed, models/split_explicit, the options the
port defers, and that no file of the port imports jax.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orthogonalsphericalshellgrids_tpu as osg
from orthogonalsphericalshellgrids_tpu.grids import tripolar as jtri
from orthogonalsphericalshellgrids_tpu.grids.immersed import (
    make_immersed_boundary as jax_make_ib)
from orthogonalsphericalshellgrids_tpu.models.split_explicit import (
    averaging_weights as jax_weights)
from orthogonalsphericalshellgrids_tpu_torch.grids import tripolar as ttri
from orthogonalsphericalshellgrids_tpu_torch.grids.immersed import make_immersed_boundary
from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import averaging_weights

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "orthogonalsphericalshellgrids_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += sorted(glob.glob(os.path.join(ROOT, "examples", "*_torch.py")))
    files += sorted(glob.glob(os.path.join(ROOT, "benchmarks", "torch_*.py")))
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_never_imports_jax():
    """No module of the port, its examples, its benchmark scripts or chip_smoke.py
    imports jax or the JAX package."""
    bad = []
    files = _port_files()
    assert len(files) > 15, files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "orthogonalsphericalshellgrids_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}: {n}")
    assert not bad, bad


@pytest.mark.parametrize("size,halo", [((48, 40, 1), (5, 5, 5)),
                                       ((48, 40, 1), (22, 22, 5)),
                                       ((60, 32, 2), (4, 3, 4))])
def test_build_tripolar_arrays_exact(size, halo):
    kw = dict(halo=halo, north_poles_latitude=35.0, first_pole_longitude=45.0)
    want = jtri.build_tripolar_arrays(size, backend="numpy", **kw)
    got = ttri.build_tripolar_arrays(size, **kw)
    assert set(want) == set(got)
    for name in want:
        if name == "meta":
            continue
        assert got[name].dtype == np.float64, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for k, v in got["meta"].items():
        assert want["meta"][k] == v, k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tripolar_grid_make_and_with_halo(dtype):
    jg = osg.TripolarGrid.make((48, 40, 1), halo=(5, 5, 5), dtype=getattr(jnp, dtype),
                               north_poles_latitude=25.0, first_pole_longitude=45.0)
    tg = ttri.TripolarGrid.make((48, 40, 1), halo=(5, 5, 5),
                                dtype=getattr(torch, dtype), device="cpu",
                                north_poles_latitude=25.0, first_pole_longitude=45.0)
    te = ttri.with_halo(tg, (22, 22, 5))
    je = jtri.with_halo(jg, (22, 22, 5))
    for j, t in ((jg, tg), (je, te)):
        assert t.shape2d == j.shape2d and t.halo == j.halo and t.size == j.size
        for name in ttri.ARRAY_FIELDS:
            a = getattr(t, name)
            assert a.dtype == getattr(torch, dtype) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
    # registered buffers move with the module
    assert len(dict(tg.named_buffers())) == len(ttri.ARRAY_FIELDS)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_immersed_boundary_exact(dtype):
    def bottom(lam, phi):
        return np.where((phi < -70) | ((np.abs(lam - 45.0) < 20) & (phi > 20)), 1.0, -0.5)

    jg = osg.TripolarGrid.make((48, 40, 1), halo=(5, 5, 5), dtype=getattr(jnp, dtype))
    tg = ttri.TripolarGrid.make((48, 40, 1), halo=(5, 5, 5),
                                dtype=getattr(torch, dtype), device="cpu")
    jib = jax_make_ib(jg, bottom)
    tib = make_immersed_boundary(tg, bottom)
    for name in ("bottom", "h_c", "h_u", "h_v", "mask_c", "mask_u", "mask_v"):
        np.testing.assert_array_equal(getattr(tib, name).numpy(),
                                      np.asarray(getattr(jib, name)), err_msg=name)
    # an interior array gives the same boundary as the function it samples
    lam = tg.interior(tg.lam_cc).numpy().astype(np.float64)
    phi = tg.interior(tg.phi_cc).numpy().astype(np.float64)
    tib2 = make_immersed_boundary(tg, bottom(lam, phi))
    assert torch.equal(tib2.h_c, tib.h_c)


@pytest.mark.parametrize("substeps", [6, 12, 30])
def test_sm05_weights_exact(substeps):
    dtau, w = averaging_weights(substeps)
    jdtau, jw = jax_weights(substeps)
    assert dtau == jdtau
    np.testing.assert_array_equal(w, jw)


def test_deferred_options_raise():
    with pytest.raises(NotImplementedError, match="phi_spacing"):
        ttri.TripolarGrid.make((16, 12, 1), device="cpu", phi_spacing=lambda p: 1.0 + 0 * p)
    with pytest.raises(NotImplementedError, match="native"):
        ttri.build_tripolar_arrays((16, 12, 1), backend="native")

"""Rotate vector fields between the tripolar (native) frame and the geographic frame,
through the PyTorch port.

Mirrors ``examples/convert_to_latlong_frame.py`` (the reference's
``examples/convert_to_latlong_frame.jl``): a purely zonal geographic velocity (u = 1,
v = 0) is rotated into the native frame of a 2-degree tripolar grid with the north
singularities at 35°N, then rotated back, and the round trip is the identity. Far from
the fictitious poles the grid approaches lat-lon, so the native-frame deflection of
the zonal flow decays going south.

Run:  python examples/convert_to_latlong_frame_torch.py [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = p.parse_args(argv)

    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.utils.rotation import (
        to_latlon_frame, to_native_frame)

    grid = TripolarGrid.make((180, 90, 1), north_poles_latitude=35.0,
                             dtype=torch.float64, device=args.device)
    u_ll = torch.ones(grid.shape2d, dtype=torch.float64, device=args.device)
    v_ll = torch.zeros_like(u_ll)

    u_tr, v_tr = to_native_frame(grid, u_ll, v_ll)        # geographic -> native
    u_back, v_back = to_latlon_frame(grid, u_tr, v_tr)    # and back

    err_u = float(grid.interior(u_back - 1.0).abs().max())
    err_v = float(grid.interior(v_back).abs().max())
    print(f"round-trip max|u-1| = {err_u:.2e}, max|v| = {err_v:.2e} on {args.device}")
    phi = grid.interior(grid.phi_cc)
    v_i = grid.interior(v_tr).abs()
    for cut in (0.0, -40.0):
        print(f"max native-frame deflection south of {cut:+.0f}deg: "
              f"{float(v_i[phi < cut].max()):.2e}")
    return err_u, err_v


if __name__ == "__main__":
    main()

"""Visualize a tripolar grid, with the PyTorch port.

The port's counterpart of ``examples/visualize_tripolar_grid.py`` (the reference's
``examples/visualize_tripolar_grid.jl``): a 60 x 30 tripolar grid with the north
singularities moved to 60N, its Face-Face and Center-Center nodes as unit-sphere
cartesian coordinates (``grids/tripolar.py:cartesian_nodes``), both hemispheres side
by side with matplotlib (Agg). No gridline-convergence singularity sits at the true
North Pole: the two fictitious poles lie at 60N, the South Pole inside Antarctica.

Run: python examples/visualize_tripolar_grid_torch.py [--out FILE] [--device cpu]
(writes tripolar_grid_nodes_torch.png; the grid lies on the card unless the CPU is
asked for).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(out="tripolar_grid_nodes_torch.png", device="cuda"):
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.grids.tripolar import cartesian_nodes

    grid = TripolarGrid.make(size=(60, 30, 1), north_poles_latitude=60.0, device=device)

    xF, yF, zF = cartesian_nodes(grid, "ff")
    xC, yC, zC = cartesian_nodes(grid, "cc")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 6))
    for k, elev in ((1, 60.0), (2, -60.0)):
        ax = fig.add_subplot(1, 2, k, projection="3d")
        ax.plot_wireframe(xF, yF, zF, color="black", linewidth=0.3)
        ax.plot_wireframe(xC, yC, zC, color="tab:blue", linewidth=0.3)
        ax.scatter([0, 0], [0, 0], [1, -1], color="red", s=40)  # the true poles
        ax.view_init(elev=elev, azim=40)
        ax.set_box_aspect((1, 1, 1))
        ax.set_axis_off()
    fig.suptitle("Tripolar grid nodes: Northern (left) / Southern (right) hemisphere")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="tripolar_grid_nodes_torch.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out, args.device)

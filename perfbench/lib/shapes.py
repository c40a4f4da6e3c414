"""Shapes of a configuration that the counts of ``perfbench/counts/`` are made of."""

from __future__ import annotations

import dataclasses

from perfbench.reference.model import sm05_weights

WORD = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass(frozen=True)
class Shapes:
    """``N``: interior points of a plane; ``P``: points of a halo-inclusive plane of the
    base grid; ``Pe``: of the free surface's widened grid; ``n_sub``
    barotropic substeps (the SM05 weights); ``n_tr`` tracers; ``word`` bytes a value."""

    N: int
    P: int
    Pe: int
    n_sub: int
    n_tr: int
    word: int


def of(cfg):
    """The ``Shapes`` of configuration ``cfg`` (its file's dict)."""
    nx, ny, h = cfg["nx"], cfg["ny"], cfg["halo"]
    n_sub = len(sm05_weights(cfg["substeps"])[1])
    he = max(n_sub + 1, h)
    return Shapes(N=nx * ny, P=(nx + 2 * h) * (ny + 2 * h), Pe=(nx + 2 * he) * (ny + 2 * he),
                  n_sub=n_sub, n_tr=len(cfg["physics"]["tracers"]),
                  word=WORD[cfg["dtype"]])

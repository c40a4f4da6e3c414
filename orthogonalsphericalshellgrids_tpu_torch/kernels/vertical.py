"""The layer-coupled vertical terms of the layered tendency: ``csrc/vertical.cu`` and
its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_vert.py:vertical_pallas``
(``_kernel``, ``pack_vert_statics``). Both compute, from halo-filled and MASKED
u, v (masking is a precondition: the flux factors dzu·dy_fc collapse to dz_k·dy_fc
only for masked velocities), the additive contributions (dGu, dGv, dGc): w from
continuity, its advection of u and v, the explicit ν_v and κ_v Laplacians, the
hydrostatic pressure gradient of the buoyancy and the centered vertical tracer flux.

Operands:

- ``u``, ``v``: (Nz, Yb, Xb); ``c``: (n_c·Nz, Yb, Xb) tracer-major; ``b``: an
  optional (Nz, Yb, Xb) prognostic buoyancy, which rides as the last tracer block
  (the wrapper takes it apart from ``c`` so the two stacks are never concatenated);
- the masks: ``vertical`` takes ``n_wet``, the (Yb, Xb) int32 plane of wet-layer
  counts (``wet_counts``): the model's masks are grid-fitted from one bottom, so
  mask_c[k] = k < n_wet, mask_u = mask_c·mask_c(i−1), mask_v = mask_c·mask_c(j−1);
  ``vertical_plain`` takes the JAX kernel's ``s_pack``, layer-major (Nz·S, Yb, Xb),
  S = 1 [mask_c] or 3 [mask_c, mask_u, mask_v] (``pack_vert_statics``; S = 3 is
  needed for ``viscous``), which ``wet_pack`` builds from the counts;
- ``g_pack``: (5, Yb, Xb) [inv_az_cc, inv_dx_fc, inv_dy_cf, dy_fc, dx_cf];
- ``coef``: the (5, Nz) layer coefficients of :func:`coefficients`.

Returns (dGu, dGv, dGc), dGc (P, Yb, Xb) with P = n_c·Nz (+ Nz with ``b``); cells
within ``REACH`` of the array edge are garbage (the kernel writes 0 there).

An ensemble of B members (``models/ensemble.py``) gives u, v, c, b a leading member
axis, (B, Nz, Yb, Xb) and (B, n_c·Nz, Yb, Xb), and gets (B, ...) stacks back, member
b's terms from its own fields; the counts, metric planes and coefficients are
shared. The plain version broadcasts over the member axis.

The kernel makes one launch (``launch_plan``): each CTA owns a tile of columns, sums
w over the tile and one column west and one row south of it from the floor up into
shared memory (a chunk of interfaces at a time), then runs the layers top down. An
ensemble's members are the grid's z index, so B members are one launch and each
member is bitwise its one-member launch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.operators import shift_m, shift_p
from . import call, check_operands, count, on_cuda

__all__ = ["vertical", "vertical_plain", "coefficients", "wet_counts", "wet_pack",
           "launch_plan", "MODES", "REACH"]

MODES = {"none": 0, "tracer_b": 1, "linear_eos": 2}
COEF_ROWS = ("dz", "rdzc", "mrdz", "nudz", "kapdz")
REACH = 1

# The tile of columns one CTA of csrc/vertical.cu owns, (rows, columns), and the most
# interfaces of w it holds in shared memory at once, per dtype; the source holds the
# same numbers and refuses a plan made for others.
TILE = {torch.float32: (8, 32), torch.float64: (8, 32)}
CHUNK = {torch.float32: 32, torch.float64: 16}
THREADS = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``vertical`` runs on the card: one launch over the (rows, columns) ``grid``
    of ``tile``s, one column a thread; each CTA holds w of ``chunk`` interfaces over
    its ``window`` (the tile and one column west and one row south), p of one layer
    over the window and the window's wet-layer counts in ``smem_bytes`` of shared
    memory. With more than ``chunk`` interfaces (Nz − 1) each chunk of w is summed
    again from the floor."""

    tile: tuple
    window: tuple
    grid: tuple
    threads: int
    chunk: int
    smem_bytes: int


def _plan(nz, Yb, Xb, tile, chunk_max, itemsize):
    TY, TX = tile
    WY, WX = TY + 1, TX + 1
    chunk = min(max(nz - 1, 1), chunk_max)
    smem = (chunk + 1) * WY * WX * itemsize + WY * WX * 4
    return LaunchPlan(tile=(TY, TX), window=(WY, WX), grid=(-(-Yb // TY), -(-Xb // TX)),
                      threads=THREADS, chunk=chunk, smem_bytes=smem)


@functools.lru_cache(maxsize=64)
def launch_plan(nz, Yb, Xb, dtype):
    """The launch plan for Nz layers of (Yb, Xb) planes of ``dtype``."""
    return _plan(nz, Yb, Xb, TILE[dtype], CHUNK[dtype],
                 torch.empty((), dtype=dtype).element_size())


def wet_counts(wet):
    """The (Yb, Xb) int32 plane of wet-layer counts of an (Nz, Yb, Xb) fluid mask
    (bool or 0/1, numpy or a tensor, k = 0 at the surface). Refuses a mask whose wet
    layers are not, in every column, the layers from the surface down to a bottom,
    since the counts could not represent it."""
    wet = (wet if torch.is_tensor(wet) else torch.as_tensor(np.array(wet))) != 0
    n = wet.sum(dim=0, dtype=torch.int32)
    layers = torch.arange(wet.shape[0], device=wet.device).view(-1, 1, 1)
    if not torch.equal(wet, layers < n):
        raise ValueError("vertical: the wet layers of a column must run from the surface "
                         "down to its bottom")
    return n


def wet_pack(n_wet, nz, S, dtype):
    """The layer-major (Nz·S, Yb, Xb) mask pack of ``vertical_plain`` from the counts:
    [mask_c] (S = 1) or [mask_c, mask_u, mask_v] (S = 3), as the model makes its masks
    (``mask_u = mask_c·roll(mask_c, 1, −1)``, ``mask_v`` along −2)."""
    layers = torch.arange(nz, device=n_wet.device).view(-1, 1, 1)
    mc = (layers < n_wet.to(torch.int64)).to(dtype)
    parts = [mc]
    if S == 3:
        parts += [mc * torch.roll(mc, 1, dims=-1), mc * torch.roll(mc, 1, dims=-2)]
    return torch.stack(parts, dim=1).reshape((nz * S,) + tuple(n_wet.shape))


def coefficients(dz, dzc, nu_v=0.0, kappa_v=0.0):
    """(5, Nz) float64 layer coefficients [dz, 1/dzc (last entry 0), -1/dz, ν_v/dz,
    κ_v/dz], computed as the Pallas kernel computes its baked-in Python floats."""
    nz = len(dz)
    out = np.zeros((len(COEF_ROWS), nz))
    out[0] = [float(d) for d in dz]
    out[1, : nz - 1] = [1.0 / float(d) for d in dzc]
    out[2] = [-1.0 / float(d) for d in dz]
    out[3] = [float(nu_v) / float(d) for d in dz]
    out[4] = [float(kappa_v) / float(d) for d in dz]
    return out


def _xp(a):
    return shift_p(a, -1)


def _xm(a):
    return shift_m(a, -1)


def _yp(a):
    return shift_p(a, -2)


def _ym(a):
    return shift_m(a, -2)


def _edge_sum(lo, hi):
    if lo is None:
        return hi
    return lo if hi is None else lo + hi


def _neg(a):
    return None if a is None else -a


def vertical_plain(u, v, c, b, s_pack, g_pack, coef, mode="none",
                   eos=(0.0, 0.0, 0.0, 0.0, 0.0), it_T=-1, it_S=-1, viscous=False,
                   diffusive=False):
    """(dGu, dGv, dGc) on whole planes, layer by layer, in ``pallas_vert.py``'s
    order (lines 198-298), over the layer axis −3 (a leading member axis broadcasts).
    ``eos`` = (g_b, α, β, T0, S0)."""
    nz = u.shape[-3]
    S = s_pack.shape[0] // nz
    IAZ, IDX, IDY, DYFC, DXCF = g_pack
    dz, rdzc, mrdz, nudz, kapdz = coef
    u = u.unbind(-3)
    v = v.unbind(-3)
    cl = c.unbind(-3)

    def MC(k):
        return s_pack[k * S]

    # interface velocities w[k] at the top of layer k, from the floor up
    w = [None] * nz
    acc = None
    for k in range(nz - 1, 0, -1):
        fu = DYFC * u[k]
        fv = DXCF * v[k]
        hdiv = dz[k] * ((_xp(fu) - fu) + (_yp(fv) - fv)) * IAZ
        acc = hdiv if acc is None else acc + hdiv
        w[k] = -acc

    # vertical momentum advection, explicit ν_v
    du = [None] * (nz + 1)
    dv = [None] * (nz + 1)
    for jf in range(1, nz):
        du[jf] = (u[jf - 1] - u[jf]) * rdzc[jf - 1]
        dv[jf] = (v[jf - 1] - v[jf]) * rdzc[jf - 1]
    cu = [None] * (nz + 1)
    cv = [None] * (nz + 1)
    for jf in range(1, nz):
        cu[jf] = 0.5 * (w[jf] + _xm(w[jf])) * du[jf]
        cv[jf] = 0.5 * (w[jf] + _ym(w[jf])) * dv[jf]
    dgu, dgv = [None] * nz, [None] * nz
    for k in range(nz):
        su = _edge_sum(cu[k], cu[k + 1])
        sv = _edge_sum(cv[k], cv[k + 1])
        dgu[k] = -0.5 * su if su is not None else torch.zeros_like(u[k])
        dgv[k] = -0.5 * sv if sv is not None else torch.zeros_like(v[k])
    if viscous:
        Fu = [None] * (nz + 1)
        Fv = [None] * (nz + 1)
        for jf in range(1, nz):
            Fu[jf] = du[jf] * (s_pack[(jf - 1) * S + 1] * s_pack[jf * S + 1])
            Fv[jf] = dv[jf] * (s_pack[(jf - 1) * S + 2] * s_pack[jf * S + 2])
        for k in range(nz):
            t = _edge_sum(Fu[k], _neg(Fu[k + 1]))
            if t is not None:
                dgu[k] = dgu[k] + nudz[k] * t
            t = _edge_sum(Fv[k], _neg(Fv[k + 1]))
            if t is not None:
                dgv[k] = dgv[k] + nudz[k] * t

    # hydrostatic pressure gradient
    if mode != "none":
        g_b, alpha, beta, T0, S0 = eos
        csum = None
        for k in range(nz):
            if mode == "linear_eos":
                bk = None
                if it_T >= 0:
                    bk = alpha * (cl[it_T * nz + k] - T0)
                if it_S >= 0:
                    t = beta * (cl[it_S * nz + k] - S0)
                    bk = -t if bk is None else bk - t
                bk = g_b * bk * MC(k)
            else:
                bk = b[..., k, :, :]
            bdz = dz[k] * bk
            csum = bdz if csum is None else csum + bdz
            p = 0.5 * bdz - csum
            dgu[k] = dgu[k] - (p - _xm(p)) * IDX
            dgv[k] = dgv[k] - (p - _ym(p)) * IDY

    # tracers: centered vertical flux divergence, κ_v
    blocks = [cl[t * nz:(t + 1) * nz] for t in range(len(cl) // nz)]
    if b is not None:
        blocks.append(b.unbind(-3))
    dgc = []
    for ct in blocks:
        F = [None] * (nz + 1)
        D = [None] * (nz + 1)
        for jf in range(1, nz):
            F[jf] = w[jf] * (0.5 * (ct[jf - 1] + ct[jf]))
            if diffusive:
                D[jf] = ((ct[jf - 1] - ct[jf]) * rdzc[jf - 1]
                         * (s_pack[(jf - 1) * S] * s_pack[jf * S]))
        for k in range(nz):
            s = _edge_sum(F[k], _neg(F[k + 1]))
            G = mrdz[k] * s if s is not None else torch.zeros_like(ct[k])
            if diffusive:
                s = _edge_sum(D[k], _neg(D[k + 1]))
                if s is not None:
                    G = G + kapdz[k] * s
            dgc.append(G * MC(k))
    return torch.stack(dgu, dim=-3), torch.stack(dgv, dim=-3), torch.stack(dgc, dim=-3)


def vertical(u, v, c, b, n_wet, g_pack, coef, mode="none",
             eos=(0.0, 0.0, 0.0, 0.0, 0.0), it_T=-1, it_S=-1, viscous=False,
             diffusive=False):
    """(dGu, dGv, dGc) of the module docstring, with the masks from the (Yb, Xb) int32
    plane ``n_wet`` of wet-layer counts, of one stack or of the (B, ...) stacks of B
    members. On the CPU the plain version runs on the mask pack ``wet_pack`` builds
    from the same counts; on a CUDA device one launch, counted as ``vertical`` (one
    member) or ``vertical_members``."""
    if u.dim() not in (3, 4):
        raise ValueError(f"vertical takes (Nz, Yb, Xb) stacks or the (B, Nz, Yb, Xb) "
                         f"stacks of B members, got {tuple(u.shape)}")
    lead = tuple(u.shape[:-3])
    nz, Yb, Xb = u.shape[-3:]
    n_c = c.shape[-3] // nz
    if mode not in MODES:
        raise ValueError(f"vertical: unknown mode {mode!r}; options: {sorted(MODES)}")
    if c.dim() != u.dim() or c.shape[-3] != n_c * nz or n_c < 1:
        raise ValueError(f"vertical: c of shape {tuple(c.shape)} is not a stack of "
                         f"tracer blocks of Nz={nz} layers like u {tuple(u.shape)}")
    if not torch.is_tensor(n_wet) or n_wet.dtype != torch.int32 or \
            tuple(n_wet.shape) != (Yb, Xb) or not n_wet.is_contiguous():
        raise ValueError(f"vertical: n_wet is a contiguous ({Yb}, {Xb}) int32 plane of "
                         f"wet-layer counts")
    if (mode == "tracer_b") != (b is not None):
        raise ValueError("vertical: b is given exactly when mode == 'tracer_b'")
    if mode == "linear_eos" and not (0 <= it_T < n_c or 0 <= it_S < n_c):
        raise ValueError("vertical: linear_eos needs a T and/or S tracer block")
    ops = dict(u=u, v=v, c=c, g_pack=g_pack, coef=coef)
    if b is not None:
        ops["b"] = b
    check_operands("vertical", ops, u.dtype,
                   dict(v=u.shape, c=lead + (n_c * nz, Yb, Xb), b=u.shape,
                        g_pack=(5, Yb, Xb), coef=(len(COEF_ROWS), nz)))
    args = (mode, eos, it_T, it_S, viscous, diffusive)
    if not on_cuda(*ops.values(), n_wet):
        s_pack = wet_pack(n_wet, nz, 3 if viscous else 1, u.dtype)
        return vertical_plain(u, v, c, b, s_pack, g_pack, coef, *args)
    n_members = lead[0] if lead else 1
    plan = launch_plan(nz, Yb, Xb, u.dtype)
    n_tr = n_c + (1 if b is not None else 0)
    dgu = torch.empty_like(u)
    dgv = torch.empty_like(v)
    dgc = torch.empty(lead + (n_tr * nz, Yb, Xb), dtype=u.dtype, device=u.device)
    call("osg_vertical", u.dtype, u.device, u.data_ptr(), v.data_ptr(), c.data_ptr(),
         None if b is None else b.data_ptr(), n_wet.data_ptr(), g_pack.data_ptr(),
         coef.data_ptr(), dgu.data_ptr(), dgv.data_ptr(), dgc.data_ptr(), nz, n_c, n_tr,
         Yb, Xb, MODES[mode], int(it_T), int(it_S), int(bool(viscous)),
         int(bool(diffusive)), *plan.tile, plan.chunk, n_members, *(float(x) for x in eos))
    count("vertical_members" if n_members > 1 else "vertical")
    return dgu, dgv, dgc

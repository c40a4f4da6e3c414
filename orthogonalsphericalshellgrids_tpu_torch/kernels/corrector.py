"""The layered step's AB2 predictor, corrector and tracer update: ``csrc/corrector.cu``
and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_corr.py:corrector_pallas``
(its math at ``pallas_corr.py:40-80``): per layer k,

    u* = (u0 + dt (w1 Gu − w2 Gu_old)) · m_u,         m_u = (dzu ≠ 0)
    u  = (u* + (U_a·inv_h_u − Σ_k u*·dzu · inv_h_u)) · m_u

the same for v, and c = (c0 + dt (w1 Gc − w2 Gc_old)) · mask_c for every tracer plane
(tracer-major over the layers) and for the prognostic buoyancy b when given. The
plain version is the torch chain of ``models/layered.py:layered_step`` for the
configurations without the implicit vertical solve (the JAX package's
``layered.py:1153-1168``).

Operands: (Nz, Yb, Xb) velocity stacks, their tendencies and ``dzu``/``dzv``; the
(n·Nz, Yb, Xb) tracer stacks; ``mask_c`` (Nz, Yb, Xb); ``inv_h_u``/``inv_h_v``
(Yb, Xb); ``U_a``/``V_a`` the barotropic averages cropped to the base layout (a
view with unit x stride, read in place); ``w1``, ``w2`` and ``dt`` 0-d tensors on the
operands' device, so the step makes no host sync.

An ensemble of B members (``models/ensemble.py``) gives the stacks, tendencies and
tracers a leading member axis, (B, Nz, Yb, Xb) and (B, n·Nz, Yb, Xb), ``U_a``/``V_a``
(B, Yb, Xb) crops of the members' free-surface planes, and ``w1``, ``w2`` (and
``dt``) each a 0-d tensor or one per member, (B,): members may be at different
iterations. ``dzu``, ``dzv``, ``mask_c`` and ``inv_h_*`` are shared. The kernel takes
the members as its grid's z index, one launch; the plain versions broadcast, with
the depth sums over the layer axis −3.
"""

from __future__ import annotations

import ctypes

import torch

from . import call, check_operands, count, on_cuda, output, placed

__all__ = ["corrector", "corrector_plain", "predictor_plain", "depth_mean_plain",
           "tracer_update_plain"]


def _lead(w, A):
    """A 0-d weight as it is; a (B,) weight shaped to broadcast over the member axis
    of ``A``."""
    return w if w.dim() == 0 else w.reshape(w.shape + (1,) * (A.dim() - 1))


def _ab2(x0, G, G_old, w1, w2, dt):
    w1, w2, dt = (_lead(w, x0) for w in (w1, w2, dt))
    return x0 + dt * (w1 * G - w2 * G_old)


def predictor_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, dzu, dzv, w1, w2, dt):
    """(u*, v*): the AB2 predictor, masked by ``dzu ≠ 0`` and ``dzv ≠ 0``."""
    return (_ab2(u0, Gu, Gu_old, w1, w2, dt) * (dzu != 0).to(dzu.dtype),
            _ab2(v0, Gv, Gv_old, w1, w2, dt) * (dzv != 0).to(dzv.dtype))


def depth_mean_plain(u_star, v_star, dzu, dzv, inv_h_u, inv_h_v, U_a, V_a):
    """(u, v): u* with its depth mean replaced by the barotropic one, masked."""
    ubar = torch.sum(u_star * dzu, dim=-3) * inv_h_u
    vbar = torch.sum(v_star * dzv, dim=-3) * inv_h_v
    return ((u_star + (U_a * inv_h_u - ubar).unsqueeze(-3)) * (dzu != 0).to(dzu.dtype),
            (v_star + (V_a * inv_h_v - vbar).unsqueeze(-3)) * (dzv != 0).to(dzv.dtype))


def tracer_update_plain(c0, Gc, Gc_old, mask_c, w1, w2, dt, b=None):
    """(c, b): the AB2 tracer update masked per layer; ``b`` is (b0, Gb, Gb_old) or
    None (then the returned b is None)."""
    nz = mask_c.shape[0]
    c = _ab2(c0, Gc, Gc_old, w1, w2, dt)
    c = (c.reshape(c.shape[:-3] + (-1, nz) + c.shape[-2:]) * mask_c).reshape(c.shape)
    return c, None if b is None else _ab2(*b, w1, w2, dt) * mask_c


def corrector_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, dzu, dzv, mask_c,
                    inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, b=None):
    """(u, v, c, b) after the predictor, the depth-mean replacement and the tracer
    update; ``b`` is (b0, Gb, Gb_old) or None (then the returned b is None). The
    layered step's implicit vertical solve goes between the first two."""
    u_star, v_star = predictor_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, dzu, dzv, w1, w2, dt)
    u, v = depth_mean_plain(u_star, v_star, dzu, dzv, inv_h_u, inv_h_v, U_a, V_a)
    return (u, v) + tracer_update_plain(c0, Gc, Gc_old, mask_c, w1, w2, dt, b)


def corrector(u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, dzu, dzv, mask_c,
              inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, b=None, out=None):
    """The fused update (module docstring) of one stack or of B members: the kernel on
    a CUDA device, the plain version on the CPU. Returns (u, v, c, b), b None when
    not given. The launch counts as ``corrector``, or ``corrector_members`` for
    B > 1. ``out`` = (u, v, c, b) buffers (b None without ``b``) receives the result
    in place of new tensors."""
    if u0.dim() not in (3, 4):
        raise ValueError(f"corrector takes (Nz, Yb, Xb) stacks or the (B, Nz, Yb, Xb) "
                         f"stacks of B members, got {tuple(u0.shape)}")
    lead = tuple(u0.shape[:-3])
    nz, Yb, Xb = u0.shape[-3:]
    if c0.dim() != u0.dim() or tuple(c0.shape[:-3]) != lead or c0.shape[-3] % nz:
        raise ValueError(f"corrector: {tuple(c0.shape)} tracer planes over "
                         f"{tuple(u0.shape)} velocities")
    stack, plane = (nz, Yb, Xb), (Yb, Xb)
    weight = {(), lead} if lead else {()}
    tensors = dict(u0=u0, Gu=Gu, Gu_old=Gu_old, v0=v0, Gv=Gv, Gv_old=Gv_old, c0=c0,
                   Gc=Gc, Gc_old=Gc_old, dzu=dzu, dzv=dzv, mask_c=mask_c,
                   inv_h_u=inv_h_u, inv_h_v=inv_h_v, w1=w1, w2=w2, dt=dt)
    shapes = dict(Gu=u0.shape, Gu_old=u0.shape, v0=u0.shape, Gv=u0.shape,
                  Gv_old=u0.shape, Gc=c0.shape, Gc_old=c0.shape, dzu=stack, dzv=stack,
                  mask_c=stack, inv_h_u=plane, inv_h_v=plane)
    if b is not None:
        tensors.update(b0=b[0], Gb=b[1], Gb_old=b[2])
        shapes.update(b0=u0.shape, Gb=u0.shape, Gb_old=u0.shape)
    check_operands("corrector", tensors, u0.dtype, shapes)
    if tuple(w1.shape) not in weight or w2.shape != w1.shape or \
            tuple(dt.shape) not in weight:
        raise ValueError(f"corrector: w1, w2 (one shape) and dt are 0-d or one per "
                         f"member {lead}, got {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(dt.shape)}")
    for name, a in (("U_a", U_a), ("V_a", V_a)):
        if a.dtype != u0.dtype or tuple(a.shape) != lead + plane or a.stride(-1) != 1:
            raise ValueError(f"corrector: {name} must be a {lead + plane} {u0.dtype} "
                             f"view with unit x stride, got {tuple(a.shape)} {a.dtype} "
                             f"strides {a.stride()}")
    if U_a.stride() != V_a.stride():
        raise ValueError("corrector: U_a and V_a must share their strides")
    outs = (None,) * 4 if out is None else tuple(out)
    if not on_cuda(*tensors.values(), U_a, V_a):
        result = corrector_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, dzu,
                                 dzv, mask_c, inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, b)
        return tuple(r if r is None else placed("corrector", r, o)
                     for r, o in zip(result, outs))
    n_members = lead[0] if lead else 1
    u, v, c = (output("corrector", a, o) for a, o in zip((u0, v0, c0), outs))
    b_new = None if b is None else output("corrector", b[0], outs[3])
    bs = (None, None, None) if b is None else b
    ptrs = [u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, *bs, dzu, dzv, mask_c,
            inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, u, v, c, b_new]
    arr = (ctypes.c_void_p * len(ptrs))(*(None if t is None else t.data_ptr()
                                          for t in ptrs))
    call("osg_corrector", u0.dtype, u0.device, arr, c0.shape[-3], nz, Yb, Xb,
         U_a.stride(-2), n_members, U_a.stride(0) if lead else 0, int(w1.dim() == 1),
         int(dt.dim() == 1))
    count("corrector_members" if n_members > 1 else "corrector")
    return u, v, c, b_new

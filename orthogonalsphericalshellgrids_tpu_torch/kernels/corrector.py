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
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["corrector", "corrector_plain", "predictor_plain", "depth_mean_plain",
           "tracer_update_plain"]


def _ab2(x0, G, G_old, w1, w2, dt):
    return x0 + dt * (w1 * G - w2 * G_old)


def predictor_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, dzu, dzv, w1, w2, dt):
    """(u*, v*): the AB2 predictor, masked by ``dzu ≠ 0`` and ``dzv ≠ 0``."""
    return (_ab2(u0, Gu, Gu_old, w1, w2, dt) * (dzu != 0).to(dzu.dtype),
            _ab2(v0, Gv, Gv_old, w1, w2, dt) * (dzv != 0).to(dzv.dtype))


def depth_mean_plain(u_star, v_star, dzu, dzv, inv_h_u, inv_h_v, U_a, V_a):
    """(u, v): u* with its depth mean replaced by the barotropic one, masked."""
    ubar = torch.sum(u_star * dzu, dim=0) * inv_h_u
    vbar = torch.sum(v_star * dzv, dim=0) * inv_h_v
    return ((u_star + (U_a * inv_h_u - ubar)[None]) * (dzu != 0).to(dzu.dtype),
            (v_star + (V_a * inv_h_v - vbar)[None]) * (dzv != 0).to(dzv.dtype))


def tracer_update_plain(c0, Gc, Gc_old, mask_c, w1, w2, dt, b=None):
    """(c, b): the AB2 tracer update masked per layer; ``b`` is (b0, Gb, Gb_old) or
    None (then the returned b is None)."""
    nz = mask_c.shape[0]
    c = _ab2(c0, Gc, Gc_old, w1, w2, dt)
    c = (c.reshape((-1, nz) + c.shape[-2:]) * mask_c).reshape(c.shape)
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
              inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, b=None):
    """The fused update (module docstring): the kernel on a CUDA device, the plain
    version on the CPU. Returns (u, v, c, b), b None when not given. The launch
    counts as ``corrector``."""
    if u0.dim() != 3:
        raise ValueError(f"corrector takes (Nz, Yb, Xb) stacks, got {tuple(u0.shape)}")
    nz, Yb, Xb = u0.shape
    if c0.dim() != 3 or c0.shape[0] % nz:
        raise ValueError(f"corrector: {tuple(c0.shape)} tracer planes over Nz={nz}")
    stack, plane = (nz, Yb, Xb), (Yb, Xb)
    tensors = dict(u0=u0, Gu=Gu, Gu_old=Gu_old, v0=v0, Gv=Gv, Gv_old=Gv_old, c0=c0,
                   Gc=Gc, Gc_old=Gc_old, dzu=dzu, dzv=dzv, mask_c=mask_c,
                   inv_h_u=inv_h_u, inv_h_v=inv_h_v, w1=w1, w2=w2, dt=dt)
    shapes = dict(Gu=stack, Gu_old=stack, v0=stack, Gv=stack, Gv_old=stack,
                  Gc=c0.shape, Gc_old=c0.shape, dzu=stack, dzv=stack, mask_c=stack,
                  inv_h_u=plane, inv_h_v=plane, w1=(), w2=(), dt=())
    if b is not None:
        tensors.update(b0=b[0], Gb=b[1], Gb_old=b[2])
        shapes.update(b0=stack, Gb=stack, Gb_old=stack)
    check_operands("corrector", tensors, u0.dtype, shapes)
    for name, a in (("U_a", U_a), ("V_a", V_a)):
        if a.dtype != u0.dtype or tuple(a.shape) != plane or a.stride(-1) != 1:
            raise ValueError(f"corrector: {name} must be a {plane} {u0.dtype} view "
                             f"with unit x stride, got {tuple(a.shape)} {a.dtype} "
                             f"strides {a.stride()}")
    if U_a.stride() != V_a.stride():
        raise ValueError("corrector: U_a and V_a must share their strides")
    if not on_cuda(*tensors.values(), U_a, V_a):
        return corrector_plain(u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, dzu, dzv,
                               mask_c, inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, b)
    u, v, c = torch.empty_like(u0), torch.empty_like(v0), torch.empty_like(c0)
    b_new = None if b is None else torch.empty_like(b[0])
    bs = (None, None, None) if b is None else b
    ptrs = [u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, *bs, dzu, dzv, mask_c,
            inv_h_u, inv_h_v, U_a, V_a, w1, w2, dt, u, v, c, b_new]
    arr = (ctypes.c_void_p * len(ptrs))(*(None if t is None else t.data_ptr()
                                          for t in ptrs))
    call("osg_corrector", u0.dtype, u0.device, arr, c0.shape[0], nz, Yb, Xb,
         U_a.stride(0))
    LAUNCHES["corrector"] += 1
    return u, v, c, b_new

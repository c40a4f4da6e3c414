"""Speed-of-light probes and ceilings: ``csrc/probes.cu`` and their plain versions.

These kernels measure the card, not the ocean: each runs the op mix of a model kernel
(or a pure stream or FMA loop) with its data on chip, so that a model kernel's time
can be set against a rate measured on the same card.

- ``baro_substep_sol``: counterpart of ``benchmarks/roofline.py:baro_substep_sol``
  (``_baro_sol_kernel``): ``n_iter`` iterations of the barotropic substep math on
  periodic tiles. The TPU kernel runs one (W, Xe) block held in VMEM; here the
  function is taken over a batch of independent tiles ``(B, 5, Wt, Xt)``, one CTA
  each, and all three accumulators are returned, ``(B, 3, Wt, Xt)``. B = 1 is the
  TPU kernel's function, whose output is ``[:, 0]``.
- ``weno_probe``: counterpart of ``benchmarks/weno_sol.py:weno_probe``
  (``_weno_sol_kernel``): ``n_iter`` chained upwind (or left-biased) WENO-5
  reconstructions on x-periodic rows of any count W, one block a row.
- ``stream_probe``: one read and one write per element, ``x · 1.000001 + 0.5``, the
  saxpy body of ``utils/profiling.py:stream_probe_gbps`` of the JAX package.
- ``fma_ceiling``: the 8-chain Horner body of ``benchmarks/weno_sol.py:fma_ceiling``,
  ``n_iter`` times per element.

Each wrapper takes the plain version for tensors on the CPU and launches its kernel
for tensors on a CUDA device. The plain versions are the tests' oracle and
``chip_smoke.py``'s; nothing on a card path calls them.
"""

from __future__ import annotations

import torch

from ..ops.advection import _weno5_left
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["baro_substep_sol", "baro_substep_sol_plain", "weno_probe", "weno_probe_plain",
           "stream_probe", "stream_probe_plain", "fma_ceiling", "fma_ceiling_plain",
           "BARO_PT", "FMA_FLOPS", "BARO_FLOPS"]

BARO_PT = 4          # rows of a tile each CUDA thread owns (csrc/probes.cu)
FMA_FLOPS = 2 * (8 + 8 * 15) + 7 + 1  # per element and iteration, as weno_sol.py:235
# per point-substep, as baro_substep_sol_plain and csrc/probes.cu compute it: the
# fluxes fx and fy 2, the divergence 4 (three adds, one multiply), eta 1, U and V
# 4 + 4, the three accumulators 6
BARO_FLOPS = 21


def baro_substep_sol_plain(spack, dpack, dtau, n_iter):
    """``n_iter`` iterations of the substep math of ``_baro_sol_kernel`` on each
    periodic tile: ``spack`` = [dy_fc, dx_cf, c_az, c_u, c_v] and ``dpack`` = [η, U,
    V, GU, GV], both (B, 5, Wt, Xt); ``dtau`` a one-element tensor. Returns the
    accumulators Σ dτ·(η, U, V) as (B, 3, Wt, Xt)."""
    dy_fc, dx_cf, c_az, c_u, c_v = spack.unbind(1)
    eta, U, V, GU, GV = dpack.unbind(1)
    dtau = dtau.reshape(())

    def rollp(a, dim):  # a[i+1]
        return torch.roll(a, -1, dims=dim)

    def rollm(a, dim):  # a[i-1]
        return torch.roll(a, 1, dims=dim)

    acc = [torch.zeros_like(eta) for _ in range(3)]
    for _ in range(n_iter):
        fx = dy_fc * U
        fy = dx_cf * V
        div = (rollp(fx, -1) - fx + rollp(fy, -2) - fy) * c_az
        eta = eta - div
        U = U - c_u * (eta - rollm(eta, -1)) + GU
        V = V - c_v * (eta - rollm(eta, -2)) + GV
        acc = [acc[0] + dtau * eta, acc[1] + dtau * U, acc[2] + dtau * V]
    return torch.stack(acc, dim=1)


def baro_substep_sol(spack, dpack, dtau, n_iter):
    """The barotropic substep probe; see ``baro_substep_sol_plain``. On a CUDA device
    one launch runs every iteration of every tile: a tile must have Wt a multiple of
    ``BARO_PT``, at most 1024 threads (Xt · Wt / BARO_PT) and its three shared planes
    within the 227 KB a block may use."""
    if spack.dim() != 4 or spack.shape[1] != 5:
        raise ValueError(f"baro_substep_sol: spack must be (B, 5, Wt, Xt), got "
                         f"{tuple(spack.shape)}")
    B, _, Wt, Xt = spack.shape
    dt = spack.dtype
    check_operands("baro_substep_sol", dict(spack=spack, dpack=dpack, dtau=dtau), dt,
                   dict(dpack=(B, 5, Wt, Xt), dtau=(1,)))
    if not on_cuda(spack, dpack, dtau):
        return baro_substep_sol_plain(spack, dpack, dtau, n_iter)
    threads = Xt * (Wt // BARO_PT)
    if Wt % BARO_PT or threads > 1024 or 3 * Wt * Xt * spack.element_size() > 232448:
        raise ValueError(f"baro_substep_sol: tile ({Wt}, {Xt}) does not fit one CTA "
                         f"(Wt a multiple of {BARO_PT}, Xt·Wt/{BARO_PT} <= 1024 threads, "
                         f"3 planes in shared memory)")
    out = torch.empty((B, 3, Wt, Xt), dtype=dt, device=spack.device)
    call("osg_baro_substep_sol", dt, spack.device, spack.data_ptr(), dpack.data_ptr(),
         dtau.data_ptr(), out.data_ptr(), B, Wt, Xt, int(n_iter))
    LAUNCHES["baro_substep_sol"] += 1
    return out


def weno_probe_plain(x, n_iter, upwind=True):
    """``n_iter`` iterations of ``_weno_sol_kernel``'s body on the (W, Xe) rows of
    ``x``, periodic in x: the (upwind-selected) WENO-5 reconstruction r of every
    cell's left face, then r − 0.5·sign(r)·|r|·1e-3."""
    c = x
    for _ in range(n_iter):
        m1, m2, m3 = (torch.roll(c, k, dims=-1) for k in (1, 2, 3))
        p1 = torch.roll(c, -1, dims=-1)
        if upwind:
            pos = c >= 0.0
            p2 = torch.roll(c, -2, dims=-1)
            r = _weno5_left(torch.where(pos, m3, p2), torch.where(pos, m2, p1),
                            torch.where(pos, m1, c), torch.where(pos, c, m1),
                            torch.where(pos, p1, m2))
        else:
            r = _weno5_left(m3, m2, m1, c, p1)
        c = r - 0.5 * torch.sign(r) * torch.abs(r) * 1e-3
    return c


def weno_probe(x, n_iter, upwind=True):
    """The WENO-5 probe on (W, Xe) rows; see ``weno_probe_plain``. On a CUDA device
    one launch runs all ``n_iter`` iterations, one block of three warps per row, the
    row and its periodic halo held in shared memory, double-buffered (Xe >= 3,
    2·(Xe + 5) values within 227 KB)."""
    if x.dim() != 2:
        raise ValueError(f"weno_probe: x must be (W, Xe), got {tuple(x.shape)}")
    check_operands("weno_probe", dict(x=x), x.dtype, {})
    if not on_cuda(x):
        return weno_probe_plain(x, n_iter, upwind)
    W, Xe = x.shape
    if Xe < 3 or 2 * (Xe + 5) * x.element_size() > 232448:
        raise ValueError(f"weno_probe: rows of {Xe} do not fit the kernel's shared "
                         f"memory (3 <= Xe, 2·(Xe + 5) values in 227 KB)")
    out = torch.empty_like(x)
    call("osg_weno_probe", x.dtype, x.device, x.data_ptr(), out.data_ptr(), W, Xe,
         int(n_iter), int(bool(upwind)))
    LAUNCHES["weno_probe"] += 1
    return out


def stream_probe_plain(x):
    return x * 1.000001 + 0.5


def stream_probe(x, out=None):
    """``x · 1.000001 + 0.5`` into ``out`` (a fresh tensor when None): one read and
    one write per element. On a CUDA device both must be 16-byte aligned."""
    if out is None:
        out = torch.empty_like(x)
    check_operands("stream_probe", dict(x=x, out=out), x.dtype, dict(out=tuple(x.shape)))
    if not on_cuda(x, out):
        return stream_probe_plain(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("stream_probe: x and out must be 16-byte aligned")
    call("osg_stream_probe", x.dtype, x.device, x.data_ptr(), out.data_ptr(), x.numel())
    LAUNCHES["stream_probe"] += 1
    return out


def _fma_body(c):
    accs = [c * (0.9 + 0.01 * k) + 0.1 * k for k in range(8)]
    for i in range(15):
        accs = [a * c + (0.01 * (i + k)) for k, a in enumerate(accs)]
    o = accs[0]
    for a in accs[1:]:
        o = o + a
    return o * 1e-3


def fma_ceiling_plain(x, n_iter):
    """``n_iter`` applications of the Horner body of ``weno_sol.py:fma_ceiling``
    (``FMA_FLOPS`` flops an element each)."""
    for _ in range(n_iter):
        x = _fma_body(x)
    return x


def fma_ceiling(x, n_iter):
    """The FMA ceiling kernel; see ``fma_ceiling_plain``. One launch, each element
    kept in a register for its ``n_iter`` iterations."""
    check_operands("fma_ceiling", dict(x=x), x.dtype, {})
    if not on_cuda(x):
        return fma_ceiling_plain(x, n_iter)
    out = torch.empty_like(x)
    call("osg_fma_ceiling", x.dtype, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
         int(n_iter))
    LAUNCHES["fma_ceiling"] += 1
    return out

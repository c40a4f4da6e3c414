"""The port's speed-of-light probes against the JAX package's Pallas probes, on the CPU.

``kernels/probes.py`` holds the plain PyTorch versions of the two TPU probe kernels
(``benchmarks/roofline.py:_baro_sol_kernel`` and ``benchmarks/weno_sol.py:
_weno_sol_kernel``); here each is held against the Pallas kernel itself, run with
``interpret=True`` as the JAX package's kernel tests run on the CPU. Bands (relative to
the largest value): float64 1e-13, float32 1e-5. XLA:CPU may contract a multiply and
an add where eager PyTorch does not, which is all the float64 band allows for.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import probes  # noqa: E402

torch.set_num_threads(1)

BANDS = {"float32": 1e-5, "float64": 1e-13}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roofline():
    return _load("roofline")


@pytest.fixture(scope="module")
def weno_sol():
    return _load("weno_sol")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pallas_baro(mod, spack, dpack, dtau, n_iter):
    """``_baro_sol_kernel`` on one (W, Xe) tile, built as roofline.py:129-147 builds
    it, in interpret mode; returns acc[0]."""
    _, W, Xe = spack.shape
    dtype = spack.dtype
    kern = functools.partial(mod._baro_sol_kernel, n_iter=n_iter, W=W, Xe=Xe)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=[pl.BlockSpec((W, Xe), lambda p, *_: (0, 0), memory_space=pltpu.VMEM)],
        scratch_shapes=[pltpu.VMEM((5, W, Xe), dtype), pltpu.VMEM((5, W, Xe), dtype),
                        pltpu.VMEM((3, W, Xe), dtype), pltpu.SemaphoreType.DMA(()),
                        pltpu.SemaphoreType.DMA(())])
    return pl.pallas_call(kern, grid_spec=grid_spec,
                          out_shape=[jax.ShapeDtypeStruct((W, Xe), dtype)],
                          interpret=True)(jnp.asarray([dtau], dtype), spack, dpack)[0]


def _numpy_baro(spack, dpack, dtau, n_iter):
    """A numpy re-statement of the substep math (all three accumulators)."""
    dy, dx, c_az, c_u, c_v = spack
    eta, U, V, GU, GV = dpack
    acc = np.zeros((3,) + eta.shape)
    for _ in range(n_iter):
        fx, fy = dy * U, dx * V
        eta = eta - (np.roll(fx, -1, 1) - fx + np.roll(fy, -1, 0) - fy) * c_az
        U = U - c_u * (eta - np.roll(eta, 1, 1)) + GU
        V = V - c_v * (eta - np.roll(eta, 1, 0)) + GV
        acc += dtau * np.stack([eta, U, V])
    return acc


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_baro_substep_sol_matches_pallas(roofline, dtype, batch):
    """The plain probe against the TPU kernel at (16, 128), n_iter 4, with the TPU
    probe's inputs (static pack 1e-6·N(0,1), dynamic pack N(0,1)); every tile of the
    batch against its own Pallas call, and all three accumulators against numpy."""
    W, Xe, n_iter, dtau = 16, 128, 4, 1e-7
    rng = np.random.default_rng(batch)
    spack = 1e-6 * rng.standard_normal((batch, 5, W, Xe))
    dpack = rng.standard_normal((batch, 5, W, Xe))
    got = probes.baro_substep_sol(torch.as_tensor(spack, dtype=getattr(torch, dtype)),
                                  torch.as_tensor(dpack, dtype=getattr(torch, dtype)),
                                  torch.tensor([dtau], dtype=getattr(torch, dtype)), n_iter)
    assert tuple(got.shape) == (batch, 3, W, Xe)
    for b in range(batch):
        want = _pallas_baro(roofline, jnp.asarray(spack[b], dtype),
                            jnp.asarray(dpack[b], dtype), dtau, n_iter)
        assert _rel(got[b, 0].numpy(), want) <= BANDS[dtype]
        ref = _numpy_baro(spack[b], dpack[b], dtau, n_iter)
        assert _rel(got[b].numpy(), ref) <= max(BANDS[dtype], 1e-14)


def _pallas_weno(mod, x, n_iter, upwind):
    """``_weno_sol_kernel`` built as weno_sol.py:174-185 builds it, in interpret
    mode."""
    W, Xe = x.shape
    kern = functools.partial(mod._weno_sol_kernel, n_iter=n_iter, W=W, Xe=Xe,
                             upwind=upwind)
    return pl.pallas_call(
        kern, grid=(1,), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((W, Xe), lambda p: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((W, Xe), x.dtype),
        scratch_shapes=[pltpu.VMEM((W, Xe), x.dtype), pltpu.SemaphoreType.DMA(())],
        interpret=True)(x)


@pytest.mark.parametrize("upwind", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weno_probe_matches_pallas(weno_sol, dtype, upwind):
    """The plain probe against the TPU kernel at (8, 128), 1 and 4 iterations: the
    upwind select is discontinuous, so the comparison stays at small n_iter."""
    x = np.random.default_rng(0).standard_normal((8, 128))
    for n_iter in (1, 4):
        want = _pallas_weno(weno_sol, jnp.asarray(x, dtype), n_iter, upwind)
        got = probes.weno_probe(torch.as_tensor(x, dtype=getattr(torch, dtype)), n_iter,
                                upwind)
        assert _rel(got.numpy(), want) <= BANDS[dtype]


def test_weno_flop_count_and_probe_tables():
    """70 flops per upwind reconstruction (tests/test_weno_sol.py pins the same count
    for the TPU accounting); the port's benchmark keeps the flop column of that table,
    and the FMA ceiling's 264 flops per element and iteration."""
    tws = _load("torch_weno_sol")
    assert tws.FLOPS_PER_RECONSTRUCTION == 70
    assert sum(f for _, f in tws.ANALYTIC) == 70
    assert probes.FMA_FLOPS == 264


def test_baro_flop_count_matches_the_plain_probe():
    """``BARO_FLOPS`` (21 a point-substep) is the element-wise arithmetic of
    ``baro_substep_sol_plain``: every add, subtract and multiply, counted by the
    elements it writes, over the iterations and tile points; the rolls, the unbind and
    the stack move data and cost none."""
    from torch.overrides import TorchFunctionMode

    # the operators reach the mode as Tensor.add, .sub and .mul
    arith = {"add", "sub", "mul", "__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
             "__rmul__"}
    flops = []

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "__name__", None) in arith:
                flops.append(out.numel())
            return out

    B, Wt, Xt, n_iter = 2, 8, 16, 3
    rng = np.random.default_rng(9)
    spack = torch.as_tensor(rng.standard_normal((B, 5, Wt, Xt)))
    dpack = torch.as_tensor(rng.standard_normal((B, 5, Wt, Xt)))
    with Count():
        probes.baro_substep_sol_plain(spack, dpack, torch.tensor([1e-3]), n_iter)
    assert sum(flops) == probes.BARO_FLOPS * B * Wt * Xt * n_iter
    assert probes.BARO_FLOPS == 21


def test_weno_probe_run_length():
    """The chained map grows the iterate. The benchmark's first 16 rows (its input is
    N(0,1) from seed 0, row-major, and rows do not interact) are finite after its 256
    iterations and no longer finite after 1024 in float32: the TPU probe's 2048
    iterations time NaN arithmetic, so ``benchmarks/torch_weno_sol.py`` stops at 256
    and checks its result finite."""
    tws = _load("torch_weno_sol")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((16, tws.WENO_XE)),
                        dtype=torch.float32)
    c = probes.weno_probe_plain(x, tws.WENO_ITER)
    assert bool(torch.isfinite(c).all()) and float(c.abs().max()) > 1e3
    assert not bool(torch.isfinite(probes.weno_probe_plain(c, 1024 - tws.WENO_ITER)).all())


@pytest.mark.parametrize("probe", ["baro", "weno", "stream", "fma"])
def test_cpu_wrappers_take_the_plain_path(probe):
    """On CPU tensors each wrapper returns its plain version's result and launches
    nothing."""
    rng = np.random.default_rng(5)
    kernels.reset_launch_counts()
    if probe == "baro":
        s = torch.as_tensor(1e-6 * rng.standard_normal((2, 5, 8, 16)))
        d = torch.as_tensor(rng.standard_normal((2, 5, 8, 16)))
        dtau = torch.tensor([1e-3], dtype=torch.float64)
        got, want = (probes.baro_substep_sol(s, d, dtau, 3),
                     probes.baro_substep_sol_plain(s, d, dtau, 3))
    elif probe == "weno":
        x = torch.as_tensor(rng.standard_normal((4, 32)))
        got, want = probes.weno_probe(x, 3), probes.weno_probe_plain(x, 3)
    elif probe == "stream":
        x = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
        got, want = probes.stream_probe(x), x * 1.000001 + 0.5
    else:
        x = torch.full((100,), 0.999, dtype=torch.float32)
        got, want = probes.fma_ceiling(x, 2), probes.fma_ceiling_plain(x, 2)
        # the Horner body in float64 numpy, twice
        ref = np.full(100, 0.999)
        for _ in range(2):
            accs = [ref * (0.9 + 0.01 * k) + 0.1 * k for k in range(8)]
            for i in range(15):
                accs = [a * ref + 0.01 * (i + k) for k, a in enumerate(accs)]
            ref = sum(accs[1:], accs[0]) * 1e-3
        assert _rel(got.numpy(), ref) <= 1e-5
    assert torch.equal(got, want)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_probe_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="spack must be"):
        probes.baro_substep_sol(torch.zeros(5, 8, 16), torch.zeros(5, 8, 16),
                                torch.zeros(1), 1)
    with pytest.raises(ValueError, match="dpack has shape"):
        probes.baro_substep_sol(torch.zeros(1, 5, 8, 16), torch.zeros(1, 5, 8, 8),
                                torch.zeros(1), 1)
    with pytest.raises(ValueError, match="must be \\(W, Xe\\)"):
        probes.weno_probe(torch.zeros(16), 1)

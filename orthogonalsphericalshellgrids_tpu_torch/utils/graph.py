"""Compiled step blocks: a model's step captured once as a pair of CUDA graphs and
replayed for every block of steps.

Counterpart: the JAX package's jitted ``lax.scan`` of steps, ``multi_step``
(``models/hydrostatic.py:1127-1140``) and ``layered_multi_step``
(``models/layered.py:1185-1194``) under ``jax.jit``, as its ``Simulation``
(``utils/simulation.py:177-187``) and ``bench.py:50`` run them. There a block is one
compiled program; here a block of n steps is n replays of a captured step, and the
host's part of a step is one graph launch where the eager step enqueues its launches
and glue from Python.

``run(step_fn, model, state, dt, n_steps)`` is the body of ``multi_step``,
``layered_multi_step`` and ``ensemble_multi_step``:

- on the CPU it is the eager loop of ``step_fn``: there is nothing to capture. A
  field the steps hand through unchanged (a layered state's b and Gb without a
  prognostic buoyancy) is cloned, so that the result shares no storage with the
  input on either device;
- on a card, the model's ``Block`` for the state's layout (the step function, the state
  kind, the device, each field's shape and dtype, so the member count) holds two
  static states X and Y, a static 0-d Δt of the model's dtype and two graphs in one
  private memory pool: A, the step from X into Y, and B, the step from Y into X (the
  step's ``out``: its kernels and last operations write the new state into the other
  buffers, so no step copies the state). A block copies the state into X and Δt into
  the static scalar (a copy or a fill on the card, no wait for it), replays A, B, A,
  ... and clones the result out, so that a later replay cannot change what a caller
  holds: two copies of the state a block.

The first call captures the pair: one eager step on a side stream first loads every
kernel and module (a step leaves its input bitwise unchanged, so it runs on X, and
the fields it hands through unchanged are shared by X and Y), then A and B are
captured; a capture runs nothing on the card. Every buffer a step allocates (the
fills' saved strips, the barotropic work sets, the glue's temporaries) comes from
the pool at a fixed address, and A's temporaries are B's, since the two never run
at once. So a replay is the eager step's arithmetic on the same inputs, bitwise. The
kernel wrappers' launches are recorded at the capture (``kernels.recording``) and
counted at each replay (``kernels.add_launches``), so a replayed block counts what
its eager loop launches.

``Simulation`` chains its blocks without the copies: with a ``keeper`` the result is
the block's own buffer, and the next block that starts from it copies nothing in.
Before any other call overwrites a kept buffer, the block calls the keeper, which
takes its state out.

A graph holds the model's arrays by their addresses and its options as they were at
the capture. A model's blocks live as long as the model (a weak mapping keyed by the
model object, so a copy of a model has none), and ``del model`` frees their pools; a
model whose arrays or options change after a capture needs a new model object. A
capture or a replay that fails raises; nothing falls back to the eager loop on a
card.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch

from .. import kernels

__all__ = ["run", "blocks", "layout", "Block"]

_BLOCKS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _names(state):
    return [f.name for f in dataclasses.fields(state)]


def _clone(state):
    return type(state)(**{name: getattr(state, name).clone() for name in _names(state)})


def blocks(model):
    """The blocks ``model`` holds: {``layout``: ``Block``}, empty before its first
    block."""
    return dict(_BLOCKS.get(model, {}))


def layout(step_fn, state):
    """The key of ``state``'s block: the step function, the state kind, the device
    and each field's name, shape and dtype."""
    return (step_fn, type(state), state.u.device,
            tuple((name, tuple(getattr(state, name).shape), getattr(state, name).dtype)
                  for name in _names(state)))


def run(step_fn, model, state, dt, n_steps: int, keeper=None):
    """``n_steps`` calls of ``step_fn(model, state, dt)``: the eager loop on the CPU,
    replays of the block's captured graphs on a card (see the module docstring).
    ``dt`` is a number or a 0-d tensor; ``n_steps = 0`` returns ``state`` itself. With
    ``keeper`` (a bound method, held weakly) a card returns the block's own buffer,
    and calls ``keeper()`` before a later call of another state overwrites it."""
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if n_steps == 0:
        return state
    key = layout(step_fn, state)
    own = _BLOCKS.setdefault(model, {})
    block = own.get(key)
    if block is None:
        block = own[key] = Block(step_fn, state.u.device)
    return block(model, state, dt, n_steps, keeper)


class Block:
    """The compiled step of one model for one state layout: ``buffers`` (X, Y),
    ``graphs`` (A: X into Y, B: Y into X), ``launches`` (one step's, by kernel
    wrapper), ``capture_seconds`` (the warm-up step and both captures) and
    ``pool_bytes`` (the memory the captures reserved for the pool); None before the
    first call on a card. On the CPU it holds nothing and runs the eager loop."""

    def __init__(self, step_fn, device):
        self.step_fn = step_fn
        self.device = device
        self.buffers = None
        self.graphs = None
        self.launches = None
        self.capture_seconds = None
        self.pool_bytes = 0
        self.dt = None  # the static 0-d Δt
        self._pool = None
        self._kept = None  # (index of the kept buffer, weak keeper)

    def __call__(self, model, state, dt, n_steps, keeper=None):
        if self.device.type != "cuda":
            result = state
            for _ in range(n_steps):
                result = self.step_fn(model, result, dt)
            held = {getattr(state, name).untyped_storage().data_ptr()
                    for name in _names(state)}
            return dataclasses.replace(result, **{
                name: getattr(result, name).clone() for name in _names(result)
                if getattr(result, name).untyped_storage().data_ptr() in held})
        self._release(state, keeper)
        k = self._load(model, state, dt)
        if self.graphs is None:
            self._capture(model)
        for _ in range(n_steps):
            self.graphs[k].replay()
            k = 1 - k
        kernels.add_launches({name: n * n_steps for name, n in self.launches.items()})
        if keeper is None:
            return _clone(self.buffers[k])
        self._kept = (k, weakref.WeakMethod(keeper))
        return self.buffers[k]

    def _release(self, state, keeper):
        """Have the keeper take its state out of the buffers, unless this call is its
        chain going on (its own kept state, from the same keeper)."""
        if self._kept is None:
            return
        held = self._kept[1]()
        if held is not None and held == keeper and state is self.buffers[self._kept[0]]:
            return
        self._kept = None
        if held is not None:
            held()

    def _load(self, model, state, dt):
        """Put ``state`` into X (no copy when it is one of the buffers, as a kept
        state is) and ``dt`` into the static scalar, on the card's current stream;
        returns the index of the buffer the block starts from."""
        if torch.is_tensor(dt) and dt.dim() != 0:
            raise ValueError(f"a block takes dt as a number or a 0-d tensor, got shape "
                             f"{tuple(dt.shape)}")
        names = _names(state)
        for name in names:
            if getattr(state, name).device != self.device:
                raise ValueError(f"state.{name} lies on {getattr(state, name).device}, "
                                 f"the state's u on {self.device}")
        if self.buffers is None:
            self.buffers = (self._allocate(state), None)
            self.dt = torch.empty((), dtype=model.dtype, device=self.device)
        if torch.is_tensor(dt):
            self.dt.copy_(dt)
        else:
            self.dt.fill_(float(dt))
        for k, buffer in enumerate(self.buffers):
            if state is buffer:
                return k
        for name in names:
            getattr(self.buffers[0], name).copy_(getattr(state, name))
        return 0

    def _allocate(self, like, shared=()):
        """A static state laid out like ``like`` (η, U and V the views of one (3,) +
        η.shape buffer, the barotropic averages' layout), with the fields ``shared``
        (name -> tensor) as they are."""
        avg = torch.empty((3,) + tuple(like.eta.shape), dtype=like.eta.dtype,
                          device=self.device)
        fields = {name: torch.empty_like(getattr(like, name),
                                         memory_format=torch.contiguous_format)
                  for name in _names(like) if name not in ("eta", "U", "V")}
        fields.update(eta=avg[0], U=avg[1], V=avg[2])
        fields.update(shared)
        return type(like)(**fields)

    def _capture(self, model):
        """Capture A (X into Y) and B (Y into X) after one eager step on X."""
        t0 = time.perf_counter()
        dev, X = self.device, self.buffers[0]
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = self.step_fn(model, X, self.dt)
            torch.cuda.current_stream(dev).wait_stream(side)
            handed = {name: getattr(X, name) for name in _names(X)
                      if getattr(warm, name) is getattr(X, name)}
            del warm
            self.buffers = (X, self._allocate(X, handed))
            self._pool = torch.cuda.graph_pool_handle()
            graphs, records = [], []
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            for k in (0, 1):
                graphs.append(torch.cuda.CUDAGraph())
                records.append(dict.fromkeys(kernels.LAUNCHES, 0))
                with kernels.recording(records[-1]), torch.cuda.graph(
                        graphs[-1], pool=self._pool, capture_error_mode="thread_local"):
                    self.step_fn(model, self.buffers[k], self.dt, out=self.buffers[1 - k])
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        if records[0] != records[1]:
            raise RuntimeError(f"the two captures of one step launched {records}")
        self.graphs, self.launches = tuple(graphs), records[0]
        self.capture_seconds = time.perf_counter() - t0

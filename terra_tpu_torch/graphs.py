"""CUDA graphs of the render's launch units: the port's counterpart of the
``jax.jit`` cache that serves ``terra_tpu.render``'s ``render_chunk``,
``render_band`` and ``render_chunks``.

The JAX package runs each launch unit as one compiled device program and
traces the key, the sample offset and the first row, so one compile serves
every seed, pass and band. Here a unit is captured once per (scene, camera,
options, samples, rows, device) into ``torch.cuda.CUDAGraph`` objects and
replayed with new inputs copied into a static buffer: the host dispatches
a few graph launches instead of every elementwise op of every loop trip.

Every unit is a :class:`StagedUnit`: a body's named stages, captured one
graph each in one memory pool, and replayed by name. A render unit's body
(``render._BandBody``) has three: ``start`` (lane ids, first rays, the
loop carry), ``step`` (a block of persistent-lane loop trips, updating the
carry in place and writing the all-finished flag) and ``finish`` (the
radiance sum); its :class:`Loop` says how :func:`drive` runs them:
``step`` until the flag is set or the block bound is reached, reading the
flag once per block. Training units (:class:`TrainUnit`) serve ``optim``'s
steps: the forward (autograd recorded inside the capture), the backward
and the optimiser's update, replayed in capture order; the sharded steps'
all-reduces run between replays. The compacted traversal
(``accel.compact``) runs its dispatch-bound stages (phase 1 with its first
two rounds, and tail rounds padded to their buckets) as units in one pool
over one run's static buffers, reading the active count back between
replays; ``profile.stage_breakdown`` times its stages as units. On the CPU
a body is its own unit: it runs eagerly, ``replay`` being ``run``.

Before capture the body runs once eagerly on a side stream under
``torch.cuda.set_sync_debug_mode("error")``, which builds the kernels and
refuses any op that synchronises with the host. A failed warm-up or
capture raises, naming the stage; nothing falls back to eager dispatch.
``render.render_rows`` stays the eager render body, by name.

The kernel wrappers count their launches in ``profile.kernel_launches``
as they enqueue them, so a replay would count nothing. A unit records what
each stage's capture added to the counter, takes it back out (the capture
launched nothing), and adds it again on every replay; it names no kernel.

Spans (``profile``): a unit's construction is ``terra.unit.capture``, its
eager warm-up nested in it as ``terra.unit.warmup``; each graph replay is
a hot ``terra.unit.replay.<stage>`` span and each read of the
all-finished flag in :func:`drive` a hot ``terra.unit.flag_read`` span.

:class:`WeakCache` keys entries on owner objects (the scene, the camera)
held weakly, drops an entry when an owner dies, and captures anew when the
owners' fingerprint changes: a tensor replaced or changed in place
(``_version``), or any plain field. The render contexts (packed traversal
tables, shading tables, env distribution) are cached the same way in
:data:`CONTEXTS`, for the eager path too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from .profile import kernel_launches, launches_taken_back, profiler

__all__ = ["Loop", "StagedUnit", "TrainUnit", "WeakCache", "fingerprint", "drive", "unit",
           "train_unit", "staged_unit", "compact_run", "units", "clear", "CONTEXTS", "MAX_UNITS",
           "MAX_TRAIN_UNITS", "MAX_COMPACT_RUNS"]

# Live captured units; the least recently used one goes first. A unit's
# pool holds about one eager call's peak memory (up to ~2 GB at the
# render's MAX_WAVEFRONT_LANES).
MAX_UNITS = 8
# Live training units: a pool holds every chunk's saved forward and the
# backward's temporaries, several GB at a 1M-lane wavefront.
MAX_TRAIN_UNITS = 2
# Live compaction runs (``accel.compact``), each its static buffers and the
# units of its stages within ``compact.GRAPH_SWEEP`` in one pool: a stage's
# temporaries, a few (lanes x F) tiles of at most 2^23 entries. Their own
# cache, so two frontiers' units never evict the render's.
MAX_COMPACT_RUNS = 4


def _leaves(obj, out: list, moving) -> list:
    """Every leaf of ``obj`` reachable through dataclass fields, dicts,
    lists and tuples: tensors as (id, data pointer, version, shape, dtype,
    device), without the version for a tensor whose id is in ``moving``
    (for every tensor when ``moving`` is None);
    other values as themselves, or by id when unhashable or hashed by
    identity (so the fingerprint holds no object alive)."""
    if isinstance(obj, torch.Tensor):
        version = None if moving is None or id(obj) in moving else obj._version
        out.append(("t", id(obj), obj.data_ptr(), version, tuple(obj.shape), obj.dtype,
                    obj.device))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out, moving)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.append(k)
            _leaves(v, out, moving)
    elif isinstance(obj, (list, tuple)):
        out.append(len(obj))
        for v in obj:
            _leaves(v, out, moving)
    elif type(obj).__hash__ is object.__hash__:  # hashed by identity: not held
        out.append(("id", id(obj)))
    else:
        try:
            hash(obj)
            out.append(obj)
        except TypeError:
            out.append(("id", id(obj)))
    return out


def fingerprint(*objs, moving=()) -> tuple:
    """What a captured graph baked in of ``objs``: changes when any tensor
    in them is replaced or written in place, or any plain field changes.
    The tensors in ``moving`` (every tensor when it is None) are inputs the
    graph reads as they stand at each replay: replacing one changes the
    fingerprint, writing it in place does not."""
    if moving is not None:
        moving = frozenset(id(t) for t in moving)
    return tuple(_leaves(list(objs), [], moving))


class WeakCache:
    """A bounded LRU map from (owner objects, static key) to a value built
    by ``make``. Owners are held weakly: an entry goes when one dies. An
    entry whose owners' :func:`fingerprint` changed is built anew. The
    value must not hold an owner strongly, or the entry never goes."""

    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()

    def get(self, owners: tuple, key, make: Callable, moving=(), watch=()):
        """The value of (owners, key). ``moving``: tensors of the owners
        fingerprinted without their version (see :func:`fingerprint`);
        ``watch``: objects fingerprinted beside the owners, not held, every
        tensor in them by identity alone (an optimiser's groups, whose
        parameters it writes in place)."""
        k = (tuple(id(o) for o in owners), key)
        fp = fingerprint(*owners, moving=moving) + fingerprint(watch, moving=None)
        hit = self._entries.get(k)
        if hit is not None and all(r() is o for r, o in zip(hit[0], owners)) and hit[1] == fp:
            self._entries.move_to_end(k)
            return hit[2]
        self._entries.pop(k, None)
        value = make()
        entries = self._entries
        refs = tuple(weakref.ref(o, lambda _r, k=k: entries.pop(k, None)) for o in owners)
        entries[k] = (refs, fp, value)
        while len(entries) > self.max_entries:
            entries.popitem(last=False)
        return value

    def values(self) -> list:
        return [v for _, _, v in self._entries.values()]

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


@contextlib.contextmanager
def _sync_debug_error():
    """Raise on any op that synchronises the host with the device."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


_REPLAY_SPANS: dict = {}


def _replay_span(stage: str):
    """The hot span of one replay of ``stage``, ``terra.unit.replay.<stage>``
    (its name made once per stage name)."""
    name = _REPLAY_SPANS.get(stage)
    if name is None:
        name = _REPLAY_SPANS[stage] = "terra.unit.replay." + stage
    return profiler.hot(name)


class Loop(NamedTuple):
    """How :func:`drive` runs a body's ``step`` stage: at most ``steps``
    blocks of ``trips_per_step`` loop trips, stopping once the 0-d bool
    device tensor ``flag`` is set (every lane finished)."""

    flag: torch.Tensor
    steps: int
    trips_per_step: int


class StagedUnit:
    """A body's stages (``body.stages``, each run by ``body.run(stage)``,
    which returns its static output) captured in order into one memory
    pool, and replayed in that order or one by one. Units whose replays
    never overlap and whose stages leave nothing in the pool after they
    end (their outputs written to buffers made outside it) may share one
    ``pool`` (``torch.cuda.graph_pool_handle()``).

    Before capture every stage runs once eagerly on a side stream under
    ``set_sync_debug_mode("error")``. The warm-up writes whatever the
    stages write in place, so ``body.save()`` before it and
    ``body.restore(saved)`` after it put that state back. A stage that
    fails to warm up or to capture raises, naming it; nothing falls back
    to eager dispatch. Host reads and collectives run between replays,
    never inside a graph. The unit copies the body's label, ``inputs``
    buffer, stages and :class:`Loop` (``body.loop``, if it has one), and
    holds ``body.keep``, never the body: a render body holds the scene and
    the camera, which the unit cache holds only weakly."""

    def __init__(self, body, device, pool=None):
        device = torch.device(device)
        self.label, self.inputs, self.stages = body.label, body.inputs, tuple(body.stages)
        self.loop = getattr(body, "loop", None)
        with profiler.span("terra.unit.capture") as whole:
            with profiler.span("terra.unit.warmup") as warm:
                saved = body.save()
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                try:
                    with torch.cuda.stream(side), _sync_debug_error():
                        for s in self.stages:
                            try:
                                body.run(s)
                            except RuntimeError as e:
                                raise RuntimeError(
                                    f"warming up stage {s!r} of {self.label} failed: {e}") from e
                finally:
                    torch.cuda.current_stream(device).wait_stream(side)
                    body.restore(saved)
                    torch.cuda.synchronize(device)
            # each capture empties the allocator's cache first; empty it
            # here too, so the reserved bytes the captures add are the pool's
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            pool = torch.cuda.graph_pool_handle() if pool is None else pool
            self._graphs = {}
            for s in self.stages:
                graph = torch.cuda.CUDAGraph()
                try:
                    with launches_taken_back() as counts, torch.cuda.graph(graph, pool=pool):
                        out = body.run(s)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"capturing stage {s!r} of {self.label} failed: {e}") from e
                self._graphs[s] = (graph, counts, out)
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.warmup_s, self.capture_s = warm.seconds, whole.seconds - warm.seconds
        # what the graphs read that no owner keeps alive (static buffers,
        # tables, a render's context and loop carry)
        self._keep = body.keep
        self.replays = 0

    def replay(self, stage: str):
        """Replay one stage; returns its static output (overwritten by the
        next replay of the stage)."""
        graph, counts, out = self._graphs[stage]
        with _replay_span(stage):
            graph.replay()
        kernel_launches.update(counts)
        if stage == self.stages[0]:
            self.replays += 1
        return out

    def describe(self) -> dict:
        """The unit's numbers: ``launches`` maps each stage to the kernel
        launches one replay of it makes, ``{kernel: n}``; ``warmup_s`` is its
        ``terra.unit.warmup`` span, ``capture_s`` the rest of its
        ``terra.unit.capture`` span; a unit with a :class:`Loop` adds its
        ``trips_per_step`` and block bound ``max_steps``."""
        out = dict(label=self.label, warmup_s=self.warmup_s, capture_s=self.capture_s,
                   pool_bytes=self.pool_bytes, replays=self.replays,
                   launches={s: dict(c) for s, (_, c, _) in self._graphs.items()})
        if self.loop is not None:
            out.update(trips_per_step=self.loop.trips_per_step, max_steps=self.loop.steps)
        return out


class TrainUnit(StagedUnit):
    """A training step's stages (``optim``'s step bodies) as a
    :class:`StagedUnit`: the forward, recorded by autograd inside the
    capture; the backward, ``torch.autograd.grad`` from the forward's saved
    tensors, which the shared pool keeps; for a step, the optimiser's
    update. The warm-up steps the optimiser, which ``body.save()`` and
    ``body.restore()`` undo. Collectives run between replays. ``cot`` is
    the body's static cotangent buffer (the sharded gradient's)."""

    def __init__(self, body, device):
        super().__init__(body, device)
        self.cot = body.cot


def drive(unit) -> tuple:
    """Run a render unit, or its body eagerly, by its :class:`Loop`:
    ``start``, then ``step`` until the all-finished flag is set (read once
    per block) or ``steps`` blocks ran, then ``finish``. Returns (output,
    loop trips run)."""
    flag, steps, trips_per_step = unit.loop
    unit.replay("start")
    n = 0
    while n < steps:
        unit.replay("step")
        n += 1
        if n < steps:
            with profiler.hot("terra.unit.flag_read"):
                done = bool(flag)
            if done:
                break
    return unit.replay("finish"), n * trips_per_step


_UNITS = WeakCache(MAX_UNITS)
_TRAIN_UNITS = WeakCache(MAX_TRAIN_UNITS)
_COMPACT_RUNS = WeakCache(MAX_COMPACT_RUNS)
CONTEXTS = WeakCache(8)


def unit(owners: tuple, key, make_body: Callable) -> StagedUnit:
    """The captured render unit of ``key`` for ``owners`` (scene, camera),
    capturing it from ``make_body()`` on a miss. ``key`` holds everything
    else the body bakes in (options, samples, rows, device)."""
    def capture():
        body = make_body()
        return StagedUnit(body, body.inputs.device)

    return _UNITS.get(owners, key, capture)


def train_unit(owners: tuple, key, make_body: Callable, moving=(), watch=()):
    """The training unit of ``key`` for ``owners`` (held weakly: the scene,
    the camera, the optimiser), made from ``make_body()`` on a miss: a
    captured :class:`TrainUnit` on a CUDA device, the body itself (run
    eagerly, ``replay`` = ``run``; it holds its owners until evicted) on
    the CPU. ``watch`` and ``moving`` as for :meth:`WeakCache.get`: the
    optimiser's parameters (watched) and the tree boxes a refit writes in
    place (moving; ``lbvh.refit_``'s kernel, on the current stream, where
    the replays run too) are inputs the graphs read at each replay, and
    writing them does not force a new capture."""
    def make():
        body = make_body()
        return TrainUnit(body, body.inputs.device) if body.inputs.is_cuda else body

    return _TRAIN_UNITS.get(owners, key, make, moving=moving, watch=watch)


def staged_unit(body, pool=None):
    """``body`` captured as a :class:`StagedUnit` (into ``pool``, if given,
    else a pool of its own) when its ``inputs`` lie on a CUDA device; on the
    CPU the body itself, run eagerly (its ``replay`` is its ``run``)."""
    return StagedUnit(body, body.inputs.device, pool) if body.inputs.is_cuda else body


def compact_run(owners: tuple, key, make: Callable):
    """The compaction run of ``key`` for ``owners`` (the BVH, held weakly),
    made by ``make()`` on a miss: an object whose ``units`` dict holds its
    units (see ``accel.compact``)."""
    return _COMPACT_RUNS.get(owners, key, make)


def units() -> list:
    """``describe()`` of every live captured unit (compaction units, render
    units, then training units), least recently used first."""
    return [u.describe() for r in _COMPACT_RUNS.values() for u in r.units.values()
            if isinstance(u, StagedUnit)] + \
        [u.describe() for u in _UNITS.values()] + \
        [u.describe() for u in _TRAIN_UNITS.values() if isinstance(u, TrainUnit)]


def clear() -> None:
    """Drop every captured unit and every cached render context (a caller
    that swaps a traversal function or the table packer under a live
    scene calls this)."""
    _COMPACT_RUNS.clear()
    _UNITS.clear()
    _TRAIN_UNITS.clear()
    CONTEXTS.clear()

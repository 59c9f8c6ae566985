"""CUDA graphs of the render's launch units: the port's counterpart of the
``jax.jit`` cache that serves ``terra_tpu.render``'s ``render_chunk``,
``render_band`` and ``render_chunks``.

The JAX package runs each launch unit as one compiled device program and
traces the key, the sample offset and the first row, so one compile serves
every seed, pass and band. Here a unit is captured once per (scene, camera,
options, samples, rows, device) into ``torch.cuda.CUDAGraph`` objects and
replayed with new inputs copied into a static buffer: the host dispatches
a few graph launches instead of every elementwise op of every loop trip.

A unit's body (``render._BandBody``) has three stages, each captured as
one graph in a shared memory pool: ``start`` (lane ids, first rays, the
loop carry), ``step`` (a block of persistent-lane loop trips, updating the
carry in place and writing the all-finished flag) and ``finish`` (the
radiance sum). :func:`drive` runs them: ``step`` until the flag is set or
the trip bound is reached, reading the flag once per block.

Before capture the body runs once eagerly on a side stream under
``torch.cuda.set_sync_debug_mode("error")``, which builds the traversal
kernels and refuses any op that synchronises with the host. A failed
capture or replay raises, naming the stage; nothing falls back to eager
rendering. ``render.render_rows`` stays the eager body, by name.

Staged units (:class:`StagedUnit`) capture a body's named stages, one
graph each in one pool. Training units (:class:`TrainUnit`) serve
``optim``'s steps this way: the forward (autograd recorded inside the
capture), the backward and the optimiser's update, replayed in capture
order; the sharded steps' all-reduces run between replays. The compacted
traversal (``accel.compact``) runs its dispatch-bound stages (phase 1 with
its first two rounds, and tail rounds padded to their buckets) as staged
units in one pool over one run's static buffers, reading the active count
back between replays; ``profile.stage_breakdown`` times its stages as
staged units.

The traversal wrappers count launches when they enqueue a kernel, so a
replay would count nothing. A unit records each graph's captured launches,
takes them back out of the counters (the capture launched nothing), and
adds them again on every replay.

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
from typing import Callable

import torch

from .accel import pallas_traverse
from .profile import profiler

__all__ = ["Unit", "StagedUnit", "TrainUnit", "WeakCache", "fingerprint", "drive", "unit",
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


@contextlib.contextmanager
def _taken_back():
    """Yields a list that receives the (binary, bvh4) launches the block
    enqueued, and restores both counters: a capture launches nothing."""
    counts = []
    l2, l4 = pallas_traverse.launches, pallas_traverse.launches4
    try:
        yield counts
    finally:
        counts[:] = [pallas_traverse.launches - l2, pallas_traverse.launches4 - l4]
        pallas_traverse.launches, pallas_traverse.launches4 = l2, l4


_REPLAY_SPANS: dict = {}


def _replay_span(stage: str):
    """The hot span of one replay of ``stage``, ``terra.unit.replay.<stage>``
    (its name made once per stage name)."""
    name = _REPLAY_SPANS.get(stage)
    if name is None:
        name = _REPLAY_SPANS[stage] = "terra.unit.replay." + stage
    return profiler.hot(name)


class Unit:
    """One launch unit captured from ``body`` (see ``render._BandBody``):
    the graphs of its stages, its static input buffer ``inputs`` (int64:
    key words, sample offset, first row), its all-finished ``flag`` and its
    static output. ``start``, ``step`` and ``finish`` replay the stages,
    so :func:`drive` runs a unit as it runs an eager body."""

    STAGES = ("start", "step", "finish")

    def __init__(self, body, device):
        device = torch.device(device)
        self.label = body.label
        self.inputs, self.flag = body.inputs, body.flag
        self.steps, self.trips_per_step = body.steps, body.trips_per_step
        stages = [s for s in self.STAGES if s != "step" or body.steps]
        with profiler.span("terra.unit.capture") as whole:
            with profiler.span("terra.unit.warmup") as warm:
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side), _sync_debug_error():
                    for s in stages:
                        getattr(body, s)()
                torch.cuda.current_stream(device).wait_stream(side)
                torch.cuda.synchronize(device)
            # each capture empties the allocator's cache first; empty it
            # here too, so the reserved bytes the captures add are the pool's
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            pool = torch.cuda.graph_pool_handle()
            self._graphs = {}
            for s in stages:
                graph = torch.cuda.CUDAGraph()
                try:
                    with _taken_back() as counts, torch.cuda.graph(graph, pool=pool):
                        out = getattr(body, s)()
                except RuntimeError as e:
                    raise RuntimeError(
                        f"capturing stage {s!r} of {self.label} failed: {e}") from e
                self._graphs[s] = (graph, tuple(counts))
            self.out = out  # the finish stage's static output
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.warmup_s, self.capture_s = warm.seconds, whole.seconds - warm.seconds
        # what the graphs read besides the scene's and camera's own
        # tensors (which their owners keep alive while the unit lives)
        self._keep = (body.ctx, body.lanes, body.state)
        self.replays = 0

    def _replay(self, stage: str):
        graph, (n2, n4) = self._graphs[stage]
        with _replay_span(stage):
            graph.replay()
        pallas_traverse.launches += n2
        pallas_traverse.launches4 += n4

    def start(self):
        self.replays += 1
        self._replay("start")

    def step(self):
        self._replay("step")

    def finish(self):
        self._replay("finish")
        return self.out

    def describe(self) -> dict:
        """The unit's numbers; ``launches`` maps each stage to the (binary,
        bvh4) kernel launches one replay of it makes; ``warmup_s`` is its
        ``terra.unit.warmup`` span, ``capture_s`` the rest of its
        ``terra.unit.capture`` span."""
        return dict(label=self.label, warmup_s=self.warmup_s, capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays,
                    launches={s: c for s, (_, c) in self._graphs.items()},
                    trips_per_step=self.trips_per_step, max_steps=self.steps)


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
    never inside a graph."""

    def __init__(self, body, device, pool=None):
        device = torch.device(device)
        self.label, self.inputs, self.stages = body.label, body.inputs, tuple(body.stages)
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
            torch.cuda.empty_cache()  # as in Unit: the reserved bytes added are the pool's
            reserved = torch.cuda.memory_reserved(device)
            pool = torch.cuda.graph_pool_handle() if pool is None else pool
            self._graphs = {}
            for s in self.stages:
                graph = torch.cuda.CUDAGraph()
                try:
                    with _taken_back() as counts, torch.cuda.graph(graph, pool=pool):
                        out = body.run(s)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"capturing stage {s!r} of {self.label} failed: {e}") from e
                self._graphs[s] = (graph, tuple(counts), out)
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.warmup_s, self.capture_s = warm.seconds, whole.seconds - warm.seconds
        # what the graphs read that no owner keeps alive (static buffers,
        # tables); the body itself holds the owners
        self._keep = body.keep
        self.replays = 0

    def replay(self, stage: str):
        """Replay one stage; returns its static output (overwritten by the
        next replay of the stage)."""
        graph, (n2, n4), out = self._graphs[stage]
        with _replay_span(stage):
            graph.replay()
        pallas_traverse.launches += n2
        pallas_traverse.launches4 += n4
        if stage == self.stages[0]:
            self.replays += 1
        return out

    def describe(self) -> dict:
        """The unit's numbers; ``launches`` maps each stage to the (binary,
        bvh4) kernel launches one replay of it makes; ``warmup_s`` and
        ``capture_s`` as for :meth:`Unit.describe`."""
        return dict(label=self.label, warmup_s=self.warmup_s, capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays,
                    launches={s: c for s, (_, c, _) in self._graphs.items()})


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


def drive(body) -> tuple:
    """Run a unit or an eager body: ``start``, then ``step`` until the
    all-finished flag is set (read once per block) or ``steps`` blocks ran,
    then ``finish``. Returns (output, loop trips run)."""
    body.start()
    n = 0
    while n < body.steps:
        body.step()
        n += 1
        if n < body.steps:
            with profiler.hot("terra.unit.flag_read"):
                done = bool(body.flag)
            if done:
                break
    return body.finish(), n * body.trips_per_step


_UNITS = WeakCache(MAX_UNITS)
_TRAIN_UNITS = WeakCache(MAX_TRAIN_UNITS)
_COMPACT_RUNS = WeakCache(MAX_COMPACT_RUNS)
CONTEXTS = WeakCache(8)


def unit(owners: tuple, key, make_body: Callable) -> Unit:
    """The captured unit of ``key`` for ``owners`` (scene, camera),
    capturing it from ``make_body()`` on a miss. ``key`` holds everything
    else the body bakes in (options, samples, rows, device)."""
    def capture():
        body = make_body()
        return Unit(body, body.inputs.device)

    return _UNITS.get(owners, key, capture)


def train_unit(owners: tuple, key, make_body: Callable, moving=(), watch=()):
    """The training unit of ``key`` for ``owners`` (held weakly: the scene,
    the camera, the optimiser), made from ``make_body()`` on a miss: a
    captured :class:`TrainUnit` on a CUDA device, the body itself (run
    eagerly, ``replay`` = ``run``; it holds its owners until evicted) on
    the CPU. ``watch`` and ``moving`` as for :meth:`WeakCache.get`: the
    optimiser's parameters (watched) and the tree boxes a refit writes in
    place (moving) are inputs the graphs read at each replay, and writing
    them does not force a new capture."""
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

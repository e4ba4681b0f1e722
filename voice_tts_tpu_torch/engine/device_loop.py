"""Device-resident loops: the JAX package's decode `while_loop`s and its
25-step CFM `scan` (`voice_tts_tpu/models/gpt/decode.py:318`,
`models/gpt/beam.py:404`, `models/s2mel/cfm.py:71`) with their state, their
positions and their stop test on the device.

A decode loop's state is a NamedTuple of tensors, and its step function is
predicated: a step taken after the stop leaves the state as it was.
`run_chunks` runs the steps CHUNK at a time and reads one flag from the
device before the first chunk and after each (`read_flag`): the loop's only
host reads.  `run_once` runs a function of fixed-shape inputs (the whole CFM
solve).  Without a `DeviceLoops`, or with one made with `capture=False`,
both run op by op (the CPU, and the uncaptured run on the card that the
graphs are held against).  With one on a CUDA device, a chunk, or the
solve, is a CUDA graph captured once per shape key and replayed.

`DeviceLoops` is one engine's cache of captured loops.  Per key it holds
the static tensors the graph reads and writes (`bind`: allocated on the
key's first use, copied into by every later request, since a graph bakes in
their addresses), the graph, its stop flag and the launch counts of one
replay.  A key's first chunk (or solve) runs op by op on the cache's side
stream, the warm-up in which each kernel's first launch sets its
attributes; then the graph is captured on that stream into one memory pool
that all keys share.  No tensor of the pool outlives a replay: results go
to the static tensors.  The generators of the draws (one, or one a request
of a batched beam) are registered with the graph, so a replayed draw
advances each as the op-by-op draw does, and a caller that restores their
states (`set_state`, `manual_seed`) replays the same streams.  A
capture or replay error propagates: nothing here falls back to the op-by-op
run.

`run_graph` runs a function of a state once a call, on the key's graph: the
continuous scheduler's chunk (`engine/continuous.py`), whose state the
caller also writes between calls (a slot's admission).

The kernel wrappers count their launches in Python (`ops/counters.py`), which
a replay does not run: a capture takes back what it counted, and each replay
adds it again, so a decode kernel counts every step a chunk executes,
including the at most CHUNK - 1 steps after the stop.

Captures run in the default global error mode, in which a CUDA call of
another thread (an allocation, a synchronisation) fails the capture.  Code
that touches the device from several threads (the continuous scheduler and
its synthesis thread, the replicas of a server) runs its device work under
`GATE.shared()`, and every capture takes `GATE.exclusive()`: it waits until
no other thread is inside a shared section, and holds the others out while
it captures.  The thread-local error mode does not make the gate needless:
with it, and no gate, the continuous chunk's first capture beside a
running synthesis thread was invalidated on the card
(`cudaErrorStreamCaptureInvalidated`).  CUDA refuses, in every mode, a
synchronisation of the whole device while one of its streams captures,
and other threads make such calls: `torch.cuda.synchronize`, the
`cudaFree` of `torch.cuda.empty_cache` (a replica's rebuild, the start
of every `torch.cuda.graph`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from voice_tts_tpu_torch.ops import counters

# decode steps a chunk: one host read a chunk (chosen on the card, PERF §6)
CHUNK = 16

# the generators a loop draws from: none, one, or one a request
Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


class CaptureGate:
    """A shared / exclusive gate over the device work of the process's
    threads.  `shared()` sections run together; `exclusive()` waits until no
    other thread is in a shared section and keeps new ones out until it
    ends.  Both nest in one thread.  A thread that asks for `exclusive()`
    inside its own shared section sets that section aside while it waits
    (it launches nothing meanwhile), so two such threads cannot deadlock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared: Dict[int, int] = {}    # thread -> depth of its shared sections
        self._owner: Optional[int] = None    # the thread in exclusive()
        self._depth = 0
        self._waiting = 0                    # threads waiting for exclusive()

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if self._owner != me and me not in self._shared:
                self._cond.wait_for(lambda: self._owner is None and not self._waiting)
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                self._shared[me] -= 1
                if not self._shared[me]:
                    del self._shared[me]
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        held = 0
        with self._cond:
            if self._owner == me:
                self._depth += 1
            else:
                held = self._shared.pop(me, 0)
                self._waiting += 1
                self._cond.wait_for(lambda: self._owner is None and not self._shared)
                self._waiting -= 1
                self._owner, self._depth = me, 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._owner = None
                    if held:
                        self._shared[me] = held
                    self._cond.notify_all()


# the process's gate: captures against the device work of other threads
GATE = CaptureGate()


def read_flag(flag: torch.Tensor) -> bool:
    """The loop's host read: whether it goes on (waits for the device)."""
    return bool(flag)


def _read(loops: Optional["DeviceLoops"], flag: torch.Tensor) -> bool:
    if loops is not None:
        loops.stats["host_reads"] += 1
    return read_flag(flag)


def select(active: torch.Tensor, new: NamedTuple, old: NamedTuple) -> NamedTuple:
    """`new` where the 0-d bool `active` holds, else `old`, field by field
    (a field that is None stays None)."""
    return type(new)(*(n if n is None else torch.where(active, n, o)
                       for n, o in zip(new, old)))


def _assign(dst: NamedTuple, src: NamedTuple) -> None:
    for d, s in zip(dst, src):
        if d is not None and d is not s:
            d.copy_(s)


class _Key:
    """One key's static tensors, graph, stop flag and launches a replay."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.flag: Optional[torch.Tensor] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}


class DeviceLoops:
    """The captured loops of one engine on one CUDA device; `capture=False`
    runs them op by op instead (the uncaptured comparison on the card)."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceLoops captures CUDA graphs, not on {self.device}")
        self.capture = capture
        self._keys: Dict[tuple, _Key] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.stats = {"graphs": 0, "capture_s": 0.0, "replays": 0, "host_reads": 0}

    def bind(self, key: tuple, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The key's static copies of `tensors` (same names, shapes and
        dtypes), holding `tensors`' values: allocated on the key's first
        use, copied into after it."""
        entry = self._keys.get(key)
        if entry is None:
            self._keys[key] = _Key({k: v.clone() for k, v in tensors.items()})
            return self._keys[key].tensors
        for k, v in tensors.items():
            entry.tensors[k].copy_(v)
        return entry.tensors

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _capture(self, entry: _Key, fn: Callable[[], None],
                 generator: Generators) -> None:
        """Capture `fn` (which writes its results into static tensors) on the
        side stream into the shared pool; its launch counts move from the
        counters to the key's launches a replay."""
        t0 = time.perf_counter()
        side = self._side()
        graph = torch.cuda.CUDAGraph()
        if isinstance(generator, torch.Generator):
            generator = (generator,)
        for g in generator or ():
            graph.register_generator_state(g)
        with GATE.exclusive():
            before = counters.snapshot()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                fn()
            after = counters.snapshot()
        entry.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for k, n in entry.launches.items():
            counters.LAUNCHES[k] -= n
        entry.graph = graph
        self.stats["graphs"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def _replay(self, entry: _Key) -> None:
        entry.graph.replay()
        for k, n in entry.launches.items():
            counters.LAUNCHES[k] += n
        self.stats["replays"] += 1

    def _warm(self, fn: Callable[[], None]) -> None:
        """Run `fn` op by op on the side stream, ordered after the work
        queued on the current stream and before what comes after."""
        side, main = self._side(), torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    def chunks(self, key: tuple, state: NamedTuple, chunk: Callable, active: Callable,
               generator: Generators) -> Tuple[NamedTuple, int]:
        """`run_chunks` on the key's graph; `state` holds static tensors of
        `bind` and is updated in place.  The caller has read the flag before
        the first chunk."""
        entry = self._keys[key]

        def step_in_place():
            _assign(state, chunk(state))
            entry.flag.copy_(active(state))

        n = 0
        if entry.graph is None:
            def first():
                _assign(state, chunk(state))
                entry.flag = active(state)
            self._warm(first)
            n = 1
            self._capture(entry, step_in_place, generator)
            if not _read(self, entry.flag):
                return state, n
        while True:
            self._replay(entry)
            n += 1
            if not _read(self, entry.flag):
                return state, n

    def graph(self, key: tuple, state: NamedTuple, fn: Callable,
              generator: Generators) -> torch.Tensor:
        """`run_graph` on the key's graph: `state` holds static tensors of
        `bind` and is updated in place; returns the key's static output."""
        entry = self._keys[key]
        if entry.graph is None:
            def first():
                new, out = fn(state)
                _assign(state, new)
                entry.out = out.clone()

            def in_place():
                new, out = fn(state)
                _assign(state, new)
                entry.out.copy_(out)
            self._warm(first)
            self._capture(entry, in_place, generator)
        else:
            self._replay(entry)
        return entry.out

    def once(self, key: tuple, inputs: Dict[str, torch.Tensor],
             fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
             generator: Generators) -> torch.Tensor:
        """`run_once` on the key's graph."""
        static = self.bind(key, inputs)
        entry = self._keys[key]
        if entry.graph is None:
            def first():
                entry.out = fn(static).clone()
            self._warm(first)
            self._capture(entry, lambda: entry.out.copy_(fn(static)), generator)
            return entry.out.clone()
        self._replay(entry)
        return entry.out.clone()


def bind(loops: Optional[DeviceLoops], key: tuple,
         tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors a loop's steps read and write: the key's static copies
    when `loops` captures, else `tensors` themselves."""
    if loops is None or not loops.capture:
        return tensors
    return loops.bind(key, tensors)


def run_chunks(state: NamedTuple, step: Callable[[NamedTuple], NamedTuple],
               active: Callable[[NamedTuple], torch.Tensor], chunk: int,
               loops: Optional[DeviceLoops], key: tuple,
               generator: Generators = None) -> Tuple[NamedTuple, int]:
    """Run the predicated `step` `chunk` steps at a time while `active(state)`
    (a 0-d bool tensor) holds: the JAX `while_loop`, tested on the host once
    before the first chunk and once after each.  Returns (the final state,
    chunks run).  With a capturing `loops`, `state` must hold the static
    tensors of `bind(loops, key, ...)`, each chunk is a replay of the key's
    graph, and the returned state is those tensors (a later request of the
    key overwrites them)."""
    def run_chunk(s):
        for _ in range(chunk):
            s = step(s)
        return s

    if not _read(loops, active(state)):
        return state, 0
    if loops is not None and loops.capture:
        return loops.chunks(key, state, run_chunk, active, generator)
    n = 0
    while True:
        state = run_chunk(state)
        n += 1
        if not _read(loops, active(state)):
            return state, n


def run_graph(state: NamedTuple, fn: Callable[[NamedTuple], Tuple[NamedTuple, torch.Tensor]],
              loops: Optional[DeviceLoops], key: tuple,
              generator: Generators = None) -> Tuple[NamedTuple, torch.Tensor]:
    """fn(state) -> (state', out) once.  With a capturing `loops`, `state`
    must hold the static tensors of `bind(loops, key, ...)`: the first call
    runs fn op by op and captures it, each later call replays the graph,
    and `out` is the key's static output (the next call overwrites it);
    otherwise fn runs op by op.  Either way `state` is updated in place and
    returned."""
    if loops is None or not loops.capture:
        new, out = fn(state)
        _assign(state, new)
        return state, out
    return state, loops.graph(key, state, fn, generator)


def run_once(inputs: Dict[str, torch.Tensor],
             fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
             loops: Optional[DeviceLoops], key: tuple,
             generator: Generators = None) -> torch.Tensor:
    """fn(inputs) -> one tensor, as a graph of the key replayed with `inputs`
    copied into its static inputs when `loops` captures (a copy of the
    result is returned), else op by op."""
    if loops is None or not loops.capture:
        return fn(inputs)
    return loops.once(key, inputs, fn, generator)


def loops_for(device: torch.device, loops: Optional[DeviceLoops]) -> Optional[DeviceLoops]:
    """The loops a device loop runs under: none on the CPU; on a CUDA device
    `loops`, or a cache of its own for this one call (captured anew) when
    the caller passed none: the card runs the loops as graphs unless the
    caller asked otherwise (`DeviceLoops(..., capture=False)`)."""
    if device.type != "cuda":
        return None
    return loops if loops is not None else DeviceLoops(device)

"""Per-phase accounting of the training epoch: spans on the trace's clock,
work counters, and traces.

Counterpart of ``diffmm_tpu/utils/profiling.py``:

* :func:`span`: a named section of the program. It is a named range in a
  trace (:func:`annotate`) and appends a record to an in-process ring of
  the last :data:`RING` records (:func:`span_records`): its name, its
  parent span's name, host enter and exit stamps from ``time.time_ns()``
  (the clock of ``torch.profiler``'s events, so each record can be placed
  in a trace), its device seconds (a pair of timing events on the current
  stream, read when the record is read, after the host has waited anyway;
  None on the CPU), and the deltas over it of the kernels' work counters
  (``ops/kernels``: launches, K4's bytes) and of the CUDA graphs' captures
  and replays by phase (:data:`GRAPHS`, counted by ``train/graphs.py``).
* :class:`StepParts`: timing events that cut a captured step into named
  parts. A capture turns each into an event-record node that every replay
  records, so the host reads the last replay's parts; the span that last
  :meth:`~StepParts.claim`\\ ed them takes that reading at the next
  :func:`settle` (a point where the host has waited for the card).
* :class:`PhaseTimer`, with its phase names (``neg_sampling``,
  ``diffusion``, ``rebuild``, ``joint``, ``eval``, and ``fused`` for a
  chunk of epochs): each phase a span. PyTorch returns before the card
  finishes, so a phase timed on the host clock alone measures what was
  enqueued; ``fence`` waits for the card (``torch.cuda.synchronize``)
  before the phase's host clock stops, making each phase's host time its
  own at the cost of the overlap between phases (``totals``, the phases
  outside any other phase of the timer). :meth:`PhaseTimer.summary` gives
  each phase's device seconds from its spans, nested ones too.
* :func:`trace` (``--trace-dir``): a ``torch.profiler`` session over the
  run, CPU and, where there is a card, CUDA activity, written as a Chrome
  trace (``trace.json``, viewed in Perfetto or ``chrome://tracing``) where
  the JAX package writes a ``jax.profiler`` trace for TensorBoard, with the
  session's span records beside it (``spans.json``).
* :func:`annotate`: a named range in the trace
  (``torch.profiler.record_function``); outside a session it records
  nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque

import torch

# records kept in the ring: a traced benchmark run reads its window's
# records after the run, about 10 an epoch
RING = 4096
# CUDA graph captures and replays by the key's phase: "<phase>.captures",
# "<phase>.replays" (train/graphs.py counts them)
GRAPHS: dict[str, int] = defaultdict(int)

_ring: deque = deque(maxlen=RING)
_open: list = []  # the spans entered and not yet left, outermost first
_claimed: list = []  # StepParts whose owner has not read them yet


def _work() -> dict[str, int]:
    from diffmm_tpu_torch.ops.kernels import work_counts

    return work_counts()


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Span:
    """One span's record (:func:`span`); :meth:`as_dict` is what readers
    get."""

    __slots__ = ("name", "parent", "enter_ns", "exit_ns", "work", "graphs", "parts", "_events",
                 "_device_s")

    def __init__(self, name: str, parent: str | None):
        self.name, self.parent = name, parent
        self.enter_ns = self.exit_ns = 0
        self.work: dict[str, int] = {}
        self.graphs: dict[str, int] = {}
        self.parts: dict[str, float] | None = None
        self._events = None
        self._device_s = None

    @property
    def device_s(self) -> float | None:
        """Device seconds from the enter to the exit event (waits for the
        exit event on first read); None without a card."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) * 1e-3
            self._events = None
        return self._device_s

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "enter_ns": self.enter_ns,
                "exit_ns": self.exit_ns, "device_s": self.device_s, "work": dict(self.work),
                "graphs": dict(self.graphs), "parts": None if self.parts is None else dict(self.parts)}


@contextlib.contextmanager
def span(name: str, device=None):
    """Record the block as span ``name`` (yields its :class:`Span`), with
    device seconds on ``device`` where it is a card."""
    rec = Span(name, _open[-1].name if _open else None)
    if _cuda(device):
        stream = torch.cuda.current_stream(device)
        rec._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec._events[0].record(stream)
    work0, graphs0 = _work(), dict(GRAPHS)
    _open.append(rec)
    rec.enter_ns = time.time_ns()
    try:
        with annotate(name):
            yield rec
    finally:
        rec.exit_ns = time.time_ns()
        _open.pop()
        if rec._events is not None:
            rec._events[1].record(torch.cuda.current_stream(device))
        rec.work = _delta(_work(), work0)
        rec.graphs = _delta(GRAPHS, graphs0)
        _ring.append(rec)


def span_records(since_ns: int = 0) -> list[dict]:
    """The ring's records (the last :data:`RING`) whose enter stamp is at
    or after ``since_ns``, oldest first, as dicts: ``name``, ``parent``,
    ``enter_ns``, ``exit_ns`` (``time.time_ns()``), ``device_s``, ``work``
    and ``graphs`` (counter deltas), ``parts`` (seconds by part name, or
    None). Reading waits for the records' device events."""
    settle()
    return [rec.as_dict() for rec in list(_ring) if rec.enter_ns >= since_ns]


class StepParts:
    """Timing boundaries that cut a step into the named ``parts``: the
    step calls :meth:`mark` with 0 as it starts, ``i`` as part ``i`` starts
    and ``len(parts)`` as it ends, so the parts tile it. On a card each mark
    records its own external timing event on the current stream: inside a
    graph's capture an event-record node that every replay records, eagerly
    a record. The events are made by the first mark, which is eager (a
    graph's first block runs before its capture); they are read once every
    boundary has been marked (a step function called alone, outside its
    phase, may mark only some)."""

    def __init__(self, name: str, parts: tuple[str, ...]):
        self.name, self.parts = name, tuple(parts)
        self.owner: Span | None = None
        self._events: list | None = None
        self._marked: set[int] = set()

    def mark(self, i: int, device) -> None:
        if not _cuda(device):
            return
        if self._events is None:
            self._events = [torch.cuda.Event(enable_timing=True, external=True)
                            for _ in range(len(self.parts) + 1)]
        self._events[i].record(torch.cuda.current_stream(device))
        self._marked.add(i)

    def claim(self, device) -> None:
        """The innermost open span owns the next reading of these parts (a
        phase claims its step's parts once, before its blocks, for steps on
        ``device``; nothing on the CPU); an earlier owner not yet settled
        loses it, since the events it would read are recorded again."""
        if not _open or not _cuda(device):
            return
        self.owner = _open[-1]
        if self not in _claimed:
            _claimed.append(self)

    def _read(self) -> dict[str, float] | None:
        ev = self._events
        if len(self._marked) < len(self.parts) + 1 or not ev[-1].query():
            return None
        return {p: ev[i].elapsed_time(ev[i + 1]) * 1e-3 for i, p in enumerate(self.parts)}


def settle() -> None:
    """The host has waited for the card: each claimed :class:`StepParts`
    whose last event is done gives its parts to its owner."""
    for parts in list(_claimed):
        reading = parts._read()
        if reading is not None:
            parts.owner.parts = reading
            parts.owner = None
            _claimed.remove(parts)


class PhaseTimer:
    """Each phase a span on ``device``; ``totals`` and ``counts`` the host
    wall seconds and calls of the phases outside any other phase of this
    timer (a fused chunk's phases only enqueue, so only the chunk counts)."""

    def __init__(self, device=None):
        self.device = device
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.spans: deque = deque(maxlen=RING)  # the phases' records since the last reset
        self._depth = 0

    @contextlib.contextmanager
    def phase(self, name: str, fence: torch.device | None = None):
        """Time the block as phase ``name``; with ``fence`` a CUDA device,
        wait for it before the host clock stops."""
        t0 = time.perf_counter()
        self._depth += 1
        try:
            with span(name, self.device) as rec:
                yield
            self.spans.append(rec)
        finally:
            self._depth -= 1
            if fence is not None and fence.type == "cuda":
                torch.cuda.synchronize(fence)
            if self._depth == 0:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def summary(self) -> str:
        """Each phase's seconds and spans since the last reset, nested ones
        included: device seconds on a card, host seconds on the CPU (where
        the work is done when the host returns)."""
        secs: dict[str, float] = defaultdict(float)
        n: dict[str, int] = defaultdict(int)
        for rec in self.spans:
            dev = rec.device_s
            secs[rec.name] += (rec.exit_ns - rec.enter_ns) * 1e-9 if dev is None else dev
            n[rec.name] += 1
        return ", ".join(f"{name}={secs[name]:.2f}s/{n[name]}" for name in sorted(secs))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.spans.clear()


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """A ``torch.profiler`` session written to ``<trace_dir>/trace.json``
    when the block ends, and the span records of the session to
    ``<trace_dir>/spans.json`` (:func:`span_records`); nothing when
    ``trace_dir`` is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    since = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as fh:
        json.dump(span_records(since), fh)


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield

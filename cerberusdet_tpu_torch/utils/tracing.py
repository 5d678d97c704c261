"""The port's spans, device stage marks and counters, in one in-memory ring.

Recording is always on, at call granularity: a span a call of a layer
(`predict`, a batch of the serving engine, a train step and their parts),
never one a row or a kernel.

  * `span(name, value=0)`: a host span, a context manager. It records its
    name, start and end (time.perf_counter_ns), its parent (the innermost
    span open on the same thread) and one integer value (rows, a task's
    index). `record` writes a span whose times the caller took (a request's
    wait in the serving engine's queue).
  * `mark(name)`: a device stage mark. Inside the capture of a
    CapturedProgram (infer/graphs.py) it records an external CUDA event,
    which becomes an event-record node of the graph, so that every replay
    re-times it; the capture adds one mark at the graph's start. A function
    marks each stage as the stage ends, so when its last act is a mark the
    stages tile the replay. Outside a capture, and on the CPU, a mark does
    nothing. The program reads the stage durations (`elapsed_time` between
    consecutive marks) of at most one replay of a program a READ_GAP_S into
    the ring, once its marks are complete, never waiting for them: a read
    costs ~0.1 ms of host time, so it costs at most ~0.05% of any run. The
    `replay` span's value says whether its replay was one to read, so a
    reader counts the share that was read.
  * A `capture` span around each capture of a CapturedProgram: a program
    built again inside a window shows as a capture there.

Records go into a preallocated ring of numpy columns (RING, 2**16 entries);
an entry written over is counted, and nothing else is kept per record.
Indices come from an atomic counter, so any thread may record. While a
torch profiler records the span's thread, the span also opens a profiler
range named "cd." + its name on the host's timeline, which the device's
activity shares. The range is a plain function range: a user annotation
would be drawn on the device's timeline as well, as if it were device work.
The profiler records only the thread that started it, so the spans of
another thread (the serving engine's runner) are in the ring alone:
`save(path)` writes the ring out, and tools/summarize_trace.py --ring
places its spans on a profile's clock by the spans both hold.

`window(t0, seconds)` is the view of the records inside a host-clock window
that the benchmark's per-layer readers (benchmark/metrics) take: what it
selects is part of what those metrics measure.
"""

from __future__ import annotations

import contextlib
import itertools
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SPAN, STAGE = 0, 1  # the kinds of record
CAPACITY = 1 << 16
PROFILER_PREFIX = "cd."
FIELDS = ("seq", "name", "kind", "t0", "t1", "parent", "value")
RECORD = np.dtype([(f, np.int64) for f in FIELDS])


class Ring:
    """Records in a preallocated array of RECORD (`rec`; its columns are
    `rec["t0"]` and so on), entry seq % capacity for the record numbered
    seq. A span is numbered when it opens and written when it closes; a
    stage record is numbered and written when the host reads it. Columns:
    seq (-1 where nothing was written), name (an index into `names`), kind
    (SPAN or STAGE), t0 and t1 (ns, time.perf_counter_ns; of a stage, t0 is
    when the host read it and t1 - t0 its device time), parent (the seq of
    the enclosing span, of a stage the `replay` span that launched it, -1
    for none), value. An entry is written whole, in one packing of its
    bytes under the interpreter lock."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.rec = np.zeros(self.capacity, RECORD)
        self.rec["seq"] = -1
        self._bytes = memoryview(self.rec).cast("B")
        self._pack = struct.Struct(f"={len(FIELDS)}q").pack_into
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        self._counter = itertools.count()  # next() on it is atomic
        self._lock = threading.Lock()

    def number(self) -> int:
        """The next record's sequence number."""
        return next(self._counter)

    def name_id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._lock:
                i = self._ids.setdefault(name, len(self.names))
                if i == len(self.names):
                    self.names.append(name)
        return i

    def write(self, seq: int, name: str, kind: int, t0: int, t1: int, parent: int,
              value: int) -> None:
        self._pack(self._bytes, seq % self.capacity * RECORD.itemsize, seq, self.name_id(name),
                   kind, t0, t1, parent, value)

    def overwritten(self) -> int:
        """Entries written over so far."""
        return max(0, int(self.rec["seq"].max()) + 1 - self.capacity)


RING = Ring()
_local = threading.local()


def _open_spans() -> List[int]:
    try:
        return _local.spans
    except AttributeError:
        _local.spans = []
        return _local.spans


def save(path) -> None:
    """Write RING's records and names to `path` (.npz), for
    tools/summarize_trace.py --ring."""
    np.savez(path, rec=RING.rec, names=np.array(RING.names, dtype=str))


class span:
    """Records one host span: `with span("predict", rows) as s:`; `s.value`
    may be set inside, `s.seq` names it as a parent. The span is written
    into the ring that numbered it."""

    __slots__ = ("name", "value", "seq", "parent", "t0", "_range", "_open", "_ring")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value

    def __enter__(self) -> "span":
        self._open = spans = _open_spans()
        self.parent = spans[-1] if spans else -1
        self._ring = RING
        self.seq = self._ring.number()
        spans.append(self.seq)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._open.pop()
        self._ring.write(self.seq, self.name, SPAN, self.t0, t1, self.parent, int(self.value))


def record(name: str, t0: int, t1: int, parent: int = -1, value: int = 0) -> None:
    """Write a span whose start and end (perf_counter_ns) the caller took."""
    ring = RING
    ring.write(ring.number(), name, SPAN, t0, t1, parent, value)


# ------------------------------------------------------------- stage marks
def mark(name: str) -> None:
    """End the stage `name` of the function being captured (see the module's
    docstring); nothing outside a capture."""
    marks = getattr(_local, "marks", None)
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        marks.append((name, ev))


READ_GAP_S = 0.25  # the least time between two replays of a program whose stages are read


class StageMarks:
    """The marks a capture recorded: `with marks.capturing():` around the
    capture adds the start mark and collects the function's marks. After
    each replay, `launched(seq)` with the `replay` span's seq says whether
    the replay is one to read: the first, then each that comes READ_GAP_S
    or more after the last one to read. `collect()` writes the stage
    durations of the replay to read into the ring that numbered its span,
    once its marks are complete; where they are not, the replay goes
    unread."""

    def __init__(self):
        self.marks: List[Tuple[str, torch.cuda.Event]] = []
        self.stages: List[Tuple[str, int]] = []  # (name, its occurrence in the graph)
        self._last = None  # perf_counter_ns of the last replay to read
        self._pending: Optional[Tuple[int, Ring]] = None

    @contextlib.contextmanager
    def capturing(self):
        _local.marks = self.marks
        try:
            mark("start")
            yield
        finally:
            _local.marks = None
        names = [n for n, _ in self.marks[1:]]
        self.stages = [(n, names[:i].count(n)) for i, n in enumerate(names)]

    def launched(self, seq: int) -> int:
        """1 where the replay launched under span `seq` is one to read."""
        now = time.perf_counter_ns()
        read = bool(self.stages) and (self._last is None
                                      or now - self._last >= READ_GAP_S * 1e9)
        if read:
            self._last = now
        self._pending = (seq, RING) if read else None
        return int(read)

    def collect(self) -> None:
        pending, self._pending = self._pending, None
        if pending is None or not self.marks[-1][1].query():
            return
        seq, ring = pending
        now = time.perf_counter_ns()
        for (_, a), (_, b), (name, k) in zip(self.marks, self.marks[1:], self.stages):
            ring.write(ring.number(), name, STAGE, now, now + round(a.elapsed_time(b) * 1e6),
                       seq, k)


# ------------------------------------------------------------------ reading
READ_SHARE = 0.9  # the least share of a window's replays to read whose stages were read


class Window:
    """The ring's records in a host-clock window [t0, t1) (ns), taken at
    once: the spans that start inside it, and the stages of the `replay`
    spans among them. Each reading is None where the window holds none of
    what it reads, or where the ring wrote over an entry that may have
    started inside the window (`complete` False)."""

    def __init__(self, ring: Ring, t0: int, t1: int):
        rec = ring.rec[ring.rec["seq"] >= 0]
        rec = rec[np.argsort(rec["seq"], kind="stable")]
        col = {k: rec[k] for k in FIELDS}
        self.col = col
        self.names = np.array(ring.names + [""], dtype=object)[col["name"]]
        self.complete = not (ring.overwritten() and len(col["seq"]) and col["t0"][0] >= t0)
        self.inside = (col["kind"] == SPAN) & (col["t0"] >= t0) & (col["t0"] < t1)
        self._pos = {int(s): i for i, s in enumerate(col["seq"])}

    def _parents(self, idx: np.ndarray) -> np.ndarray:
        """The names of the parents of records idx ("" where unknown)."""
        pos = [self._pos.get(int(p)) for p in self.col["parent"][idx]]
        return np.array(["" if i is None else self.names[i] for i in pos], dtype=object)

    def spans(self, names: Tuple[str, ...], parents: Tuple[str, ...] = ()) -> np.ndarray:
        """Indices of the window's spans called one of `names` (whose
        parent is called one of `parents`, where given)."""
        idx = np.flatnonzero(self.inside & np.isin(self.names, names))
        if parents and len(idx):
            idx = idx[np.isin(self._parents(idx), parents)]
        return idx

    def ms(self, idx: np.ndarray) -> np.ndarray:
        return (self.col["t1"][idx] - self.col["t0"][idx]) / 1e6

    def host_ms_per(self, names: Tuple[str, ...], parents: Tuple[str, ...],
                    per: str) -> Optional[float]:
        """The summed ms of the spans called one of `names` under `parents`,
        over the count of the window's `per` spans."""
        n = len(self.spans((per,)))
        if not self.complete or not n:
            return None
        return float(self.ms(self.spans(names, parents)).sum()) / n

    def percentile(self, names: Tuple[str, ...], q: float) -> Optional[float]:
        """The q-th percentile of the ms of the window's spans called one of
        `names`."""
        ms = self.ms(self.spans(names))
        if not self.complete or not len(ms):
            return None
        return float(np.percentile(ms, q))

    def fill_pct(self, name: str, capacity: int) -> Optional[float]:
        """The values (rows) of the window's `name` spans that hold any, over
        their count times `capacity`, in %."""
        rows = self.col["value"][self.spans((name,))]
        rows = rows[rows > 0]
        if not self.complete or not len(rows):
            return None
        return 100.0 * float(rows.sum()) / (len(rows) * capacity)

    def stage_ms_per_replay(self, names: Tuple[str, ...], parent: str) -> Optional[float]:
        """The summed device ms of the stages called one of `names`, over the
        replays that `parent` spans launched in the window and whose stages
        were read; None where fewer than READ_SHARE of the replays to read
        (a `replay` span's value 1) were read."""
        idx = self.spans(("replay",), (parent,))
        replays = self.col["seq"][idx[self.col["value"][idx] == 1]]
        stages = np.flatnonzero((self.col["kind"] == STAGE)
                                & np.isin(self.col["parent"], replays))
        read = len(np.unique(self.col["parent"][stages]))
        if not self.complete or not len(replays) or read < READ_SHARE * len(replays):
            return None
        return float(self.ms(stages[np.isin(self.names[stages], names)]).sum()) / read


def window(t0_s: float, seconds: float) -> Window:
    """The records of RING in the host-clock window that starts at
    time.perf_counter() `t0_s` and lasts `seconds`."""
    t0 = int(round(t0_s * 1e9))
    return Window(RING, t0, t0 + int(round(seconds * 1e9)))

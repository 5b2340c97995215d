"""Timing and the port's tracer (port of
``gps_optimize_slam_tpu.utils.profiling``).

* ``wallclock``: host wall time of a call, the first call (kernel build and
  load included) apart from the warm ones, every CUDA device that holds an
  output synchronised before the clock stops. PyTorch returns before the
  card finishes; synchronising the output's devices is what makes a host
  clock read the device's work.
* The tracer: host spans, device marks and counters at the program's own
  sites (``utils.graphs``, ``parallel.mesh``, ``models.fusion``,
  ``models.pose_graph``, ``pipeline``). It is off unless ``enable()`` is
  called; off, a site costs one test of a module global and gets the shared
  no-op context, allocating, recording and launching nothing.

  - ``span(name)``: a host span, ``(name, thread id, start_ns, end_ns)`` on
    ``time.time_ns``, the clock ``torch.profiler``'s device events are put
    on. Spans nest.
  - ``device_span(name, device)``: device work bracketed by two marks on
    the device's current stream. A mark is a one-thread kernel
    (``csrc/trace_marks.cu``) that reads the card's ``%globaltimer`` and
    writes it, with the mark's id, into the next slot of the device's ring
    (``RING_SLOTS`` slots of an int64 stamp and an int32 id: 768 KiB a
    card). Captured into a program (``utils.graphs``) the marks are graph
    nodes and run on every replay with no host synchronisation; CUDA events
    in a graph would be overwritten by the next replay before being read.
    A mark that finds its ring full is dropped and counted. On the CPU a
    mark writes ``time.time_ns()`` into a host ring decoded the same way.
  - ``count(name, n)``: a host counter. Counted inside a capture
    (``utils.graphs``) it goes to the capture's tally, which each replay of
    the program adds (``tally_counts``, ``add_counts``), as the kernels'
    launch counts do. ``count_device(name, t)``: adds the
    device value ``t`` into the device's counters, a tensor allocated once
    and zeroed in place by ``reset()`` (a captured program holds its
    address).
  - ``records()``: synchronises once, reads the rings and the counters,
    pairs each begin mark with its end and maps the card's stamps onto
    ``time.time_ns`` by calibration pairs (an eager mark between two host
    clock reads) taken at ``enable()`` and at each ``records()``. Returns
    every record since the last ``reset()``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.ops import _build

# Slots of a device's mark ring: a 30-s window of either benchmark cell
# takes fewer (the batch about 48 marks a request, 55 ms a request).
RING_SLOTS = 65536
# Device counters a device holds.
MAX_COUNTERS = 64
# Eager marks a calibration makes; the one with the shortest host bracket
# gives the pair.
CALIBRATION_MARKS = 8

_ON = False
_NULL = contextlib.nullcontext()
_LOCK = threading.RLock()
_SPANS: list = []  # (name, thread id, start_ns, end_ns)
_MARKS: list = []  # (name, device index (-1 for the CPU), start_ns, end_ns), paired and mapped
_COUNTS: Dict[str, int] = {}
_NAMES: list = []  # mark names; a name's begin mark has id 2 k, its end 2 k + 1
_MARK_IDS: Dict[str, int] = {}
_COUNTER_SLOTS: Dict[str, int] = {}
_RINGS: Dict[torch.device, "_Ring"] = {}
_LOST = {"dropped": 0, "unpaired": 0}
_TALLY = threading.local()  # ``counts``: the host counts of this thread's capture, or None


def _devices(result) -> set:
    """The CUDA devices of every tensor in ``result`` (tensors, NamedTuples,
    tuples, lists and dicts of them, any depth)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*(_devices(x) for x in result)) if result else set()
    return set()


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result``."""
    for device in _devices(result):
        torch.cuda.synchronize(device)


def wallclock(fn: Callable, *args, runs: int = 10, **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: ``{"compile_s", "median_ms", "min_ms"}``.
    ``compile_s`` is the first call, which builds and loads the kernels on
    first use; the others are ``runs`` warm calls."""
    t0 = time.perf_counter()
    synchronize(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        synchronize(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"compile_s": compile_s, "median_ms": float(np.median(times)), "min_ms": float(np.min(times))}


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


def _label(name: str, detail) -> str:
    return name if detail is None else f"{name}:{getattr(detail, '__name__', detail)}"


class _Span:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        _SPANS.append((self.name, threading.get_ident(), self.start, time.time_ns()))
        return False


class _DeviceSpan:
    __slots__ = ("ring", "id")

    def __init__(self, ring: "_Ring", mark_id: int):
        self.ring, self.id = ring, mark_id

    def __enter__(self):
        self.ring.mark(self.id)
        return self

    def __exit__(self, *exc):
        self.ring.mark(self.id + 1)
        return False


class _Ring:
    """A device's marks (a ring of stamps and ids, its head and tail) and
    its counters; on a card the ring is device memory written by the mark
    kernel, on the CPU NumPy arrays written here. ``calibration`` holds the
    card's (device stamp, host time) pairs; ``open`` the begin stamps
    awaiting their end, by mark id."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capacity = RING_SLOTS
        self.open: Dict[int, list] = {}
        self.calibration: list = []
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the tracer's ring on {device} must exist before a capture: enable() makes it")
            with torch.cuda.device(device):
                self.header = torch.zeros(2, dtype=torch.int64, device=device)
                self.stamps = torch.zeros(self.capacity, dtype=torch.int64, device=device)
                self.ids = torch.zeros(self.capacity, dtype=torch.int32, device=device)
                self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.float64, device=device)
                self._cal = (torch.zeros(2, dtype=torch.int64, device=device),
                             torch.zeros(CALIBRATION_MARKS, dtype=torch.int64, device=device),
                             torch.zeros(CALIBRATION_MARKS, dtype=torch.int32, device=device))
            self._lib = _build.library()
            self._ring = tuple(t.data_ptr() for t in (self.header, self.stamps, self.ids))
            self.calibrate()
        else:
            self.header = np.zeros(2, np.int64)
            self.stamps = np.zeros(self.capacity, np.int64)
            self.ids = np.zeros(self.capacity, np.int32)
            self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.float64, device=device)

    def _launch(self, ring, capacity: int, mark_id: int) -> None:
        """A mark kernel on the device's current stream, writing into
        ``ring`` (the addresses of a header, stamps and ids)."""
        with torch.cuda.device(self.device):
            rc = self._lib.gps_trace_mark(*ring, capacity, mark_id, torch.cuda.current_stream(self.device).cuda_stream)
        if rc:
            _build.check(rc, "trace mark")

    def mark(self, mark_id: int) -> None:
        if self.device.type == "cuda":
            self._launch(self._ring, self.capacity, mark_id)
            return
        now = time.time_ns()
        with _LOCK:
            n = int(self.header[0])
            self.header[0] = n + 1
            if n - int(self.header[1]) < self.capacity:
                self.stamps[n % self.capacity] = now
                self.ids[n % self.capacity] = mark_id

    def calibrate(self) -> None:
        """Add a (device stamp, host time) pair: ``CALIBRATION_MARKS`` eager
        marks, each bracketed by host clock reads after a synchronisation
        and after the next; the mark of the shortest bracket gives the
        pair, at its bracket's middle."""
        header, stamps, ids = self._cal
        header.zero_()
        ring = tuple(t.data_ptr() for t in self._cal)
        brackets = []
        for _ in range(CALIBRATION_MARKS):
            torch.cuda.synchronize(self.device)
            t0 = time.time_ns()
            self._launch(ring, CALIBRATION_MARKS, 0)
            torch.cuda.synchronize(self.device)
            brackets.append((time.time_ns() - t0, t0))
        k = min(range(CALIBRATION_MARKS), key=lambda i: brackets[i][0])
        width, t0 = brackets[k]
        self.calibration.append((int(stamps[k].item()), t0 + width // 2))

    def to_host_ns(self, stamps: np.ndarray) -> np.ndarray:
        """Device stamps on ``time.time_ns``: the line through the first
        and last calibration pairs (the offset of the last where they lie
        under 0.1 s apart); the CPU's stamps as they are."""
        if not self.calibration:
            return stamps
        (d0, h0), (d1, h1) = self.calibration[0], self.calibration[-1]
        if d1 - d0 < 100_000_000:
            return stamps + (h1 - d1)
        return h0 + np.round((stamps - d0) * ((h1 - h0) / (d1 - d0))).astype(np.int64)

    def drain(self) -> None:
        """Read the marks since the last drain (the device synchronised),
        pair them and add them to the records, count the dropped, and move
        the tail to the head."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.calibrate()
            head, tail = (int(x) for x in self.header.cpu().tolist())
            stamps, ids = self.stamps.cpu().numpy(), self.ids.cpu().numpy()
        else:
            head, tail = int(self.header[0]), int(self.header[1])
            stamps, ids = self.stamps, self.ids
        kept = min(head - tail, self.capacity)
        slots = (tail + np.arange(kept)) % self.capacity
        order_ids, host_ns = ids[slots], self.to_host_ns(stamps[slots].astype(np.int64))
        index = -1 if self.device.index is None else int(self.device.index)
        unpaired = 0
        for mark_id, at in zip(order_ids.tolist(), host_ns.tolist()):
            begins = self.open.setdefault(mark_id & ~1, [])
            if not mark_id & 1:
                begins.append(at)
            elif begins:
                _MARKS.append((_NAMES[mark_id >> 1], index, begins.pop(), at))
            else:
                unpaired += 1
        _LOST["dropped"] += head - tail - kept
        _LOST["unpaired"] += unpaired
        if self.device.type == "cuda":
            self.header[1].fill_(head)
            torch.cuda.synchronize(self.device)
        else:
            self.header[1] = head

    def zero(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.header.zero_()
            self.counters.zero_()
            torch.cuda.synchronize(self.device)
        else:
            self.header[:] = 0
            self.counters.zero_()
        self.open.clear()


def _ring(device) -> _Ring:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ring = _RINGS.get(device)
    if ring is None:
        with _LOCK:
            ring = _RINGS.get(device) or _RINGS.setdefault(device, _Ring(device))
    return ring


def _mark_id(name: str) -> int:
    mark_id = _MARK_IDS.get(name)
    if mark_id is None:
        with _LOCK:
            if name not in _MARK_IDS:
                _MARK_IDS[name] = 2 * len(_NAMES)
                _NAMES.append(name)
            mark_id = _MARK_IDS[name]
    return mark_id


def enable() -> None:
    """Turn the tracer on; make each card's ring and counters, with their
    first calibration pair, where the card has none yet."""
    global _ON
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            _ring(torch.device("cuda", i))
    _ON = True


def disable() -> None:
    """Turn the tracer off (what it recorded stays until ``reset()``)."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Drop every record and zero the rings and counters in place."""
    with _LOCK:
        for ring in list(_RINGS.values()):
            ring.zero()
        _SPANS.clear()
        _MARKS.clear()
        _COUNTS.clear()
        _LOST.update(dropped=0, unpaired=0)


def span(name: str, detail=None):
    """A host span named ``name`` (``name:detail`` with a ``detail``: a
    string, or a function whose name is taken)."""
    if not _ON:
        return _NULL
    return _Span(_label(name, detail))


def device_span(name: str, device):
    """Marks on ``device``'s current stream before and after the block's
    device work (inside a capture, graph nodes)."""
    if not _ON:
        return _NULL
    return _DeviceSpan(_ring(device), _mark_id(name))


def count(name: str, n=1, detail=None) -> None:
    """Add ``n`` to the host counter ``name`` (``name:detail``)."""
    if not _ON:
        return
    label = _label(name, detail)
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[label] = tally.get(label, 0) + n
        return
    with _LOCK:
        _COUNTS[label] = _COUNTS.get(label, 0) + n


@contextlib.contextmanager
def tally_counts():
    """Within it (a capture), this thread's host counts go to the yielded
    dict and not to the records: the capture runs the program's host code
    once, and ``add_counts`` adds the tally at each replay."""
    saved = getattr(_TALLY, "counts", None)
    _TALLY.counts = tally = {}
    try:
        yield tally
    finally:
        _TALLY.counts = saved


def add_counts(tally: dict) -> None:
    """Add a capture's tally of host counts (``tally_counts``) to the
    records."""
    if not _ON or not tally:
        return
    with _LOCK:
        for label, n in tally.items():
            _COUNTS[label] = _COUNTS.get(label, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the 0-d tensor ``value`` into the device counter ``name`` on its
    device (on a card an in-place add on the current stream, which a
    capture records)."""
    if not _ON:
        return
    slot = _COUNTER_SLOTS.get(name)
    if slot is None:
        with _LOCK:
            if name not in _COUNTER_SLOTS and len(_COUNTER_SLOTS) >= MAX_COUNTERS:
                raise RuntimeError(f"more than {MAX_COUNTERS} device counters")
            slot = _COUNTER_SLOTS.setdefault(name, len(_COUNTER_SLOTS))
    counters = _ring(value.device).counters
    if value.device.type == "cuda":
        counters[slot].add_(value)
        return
    with _LOCK:  # the host's add is a read-modify-write that threads would interleave
        counters[slot].add_(value)


def records() -> dict:
    """Everything recorded since ``reset()``: ``spans`` [(name, thread,
    start_ns, end_ns)], ``marks`` [(name, device index, start_ns, end_ns)]
    (device spans on ``time.time_ns``, -1 the CPU's), ``counts`` {name:
    n}, ``device_counts`` {name: value summed over the devices},
    ``dropped`` (marks a full ring dropped) and ``unpaired`` (end marks
    with no begin)."""
    with _LOCK:
        rings = list(_RINGS.values())
        for ring in rings:
            ring.drain()
        totals = np.zeros(MAX_COUNTERS)
        for ring in rings:
            totals += ring.counters.cpu().numpy()
        return {"spans": list(_SPANS), "marks": list(_MARKS), "counts": dict(_COUNTS),
                "device_counts": {name: float(totals[slot]) for name, slot in _COUNTER_SLOTS.items()},
                "dropped": _LOST["dropped"], "unpaired": _LOST["unpaired"]}

"""Compiled programs on the card: the counterpart of ``jax.jit`` and its
cache (``models/fusion.py``, ``parallel/mesh.py`` and ``parallel/seqpar.py``
of the JAX package compile each program once per static config and shape).

``run(fn, *args, **kwargs)`` runs ``fn`` as a CUDA graph captured on the
second call for a key and replayed from then on. The arguments are a pytree
(``torch.utils._pytree``: tuples, lists, dicts, NamedTuples); its tensors
are the program's inputs and every other leaf (a frozen config, a float, a
string, None) is static. The key is ``fn``, the tree's structure, the
static leaves, and each tensor's shape, dtype and device.

* The first call for a key runs ``fn`` eagerly on the device's capture
  stream (which builds the kernels, fills K2's per-device block count and
  makes per-stream state such as cuBLAS's workspace outside any graph) and
  remembers the key. A shape called once (one ``fuse`` command, a log of a
  new length) costs no capture and holds no memory.
* The second call captures ``fn`` into a graph that reads static input
  buffers; it and every later call copy their tensors into those buffers,
  replay the graph (the hand-written kernels launch inside it) and return
  CLONES of the graph's outputs, so a replay never overwrites a result
  handed out before, as the JAX package's fresh arrays are never
  overwritten.
* All programs of a device share one memory pool, so the pool holds the
  largest program's working set and the held programs' outputs, not a
  working set a program. Replays on a device are serialised (one lock a
  device, and a replay waits for the stream of the one before): a replay
  may overwrite another program's intermediates and static outputs, whose
  clones were taken before it.
* The programs are held in a least-recently-used cache of at most
  ``MAX_PROGRAMS`` a device whose static inputs and outputs take at most
  ``MAX_HELD_SHARE`` of the card's memory; ``stats()`` reports the pools'
  and the held bytes. ``clear()`` drops them all.
* Traced (``utils.profiling`` on), a call records host spans of its key,
  copy-in, launch (the ``replay()`` call), clone-out, first call and
  capture, each ``<span>:<function name>``; a replay lies between two
  device marks (``graphs.replay``) and adds its graph's kernel nodes,
  counted at capture, to the ``graph.kernels:<function name>`` counter,
  and the host counts its body made at capture (``profiling.tally_counts``).
  Whether the tracer is on is part of the key: an untraced call replays
  the untraced graph.
* Tensors off the card run ``fn`` directly: the caller asked for the CPU.
  So does a call inside ``eager()`` (the counterpart of
  ``jax.disable_jit()``), and a call made inside another program's first
  call or capture (it is part of that program). On a card a capture or
  replay that fails raises; nothing falls back to eager dispatch.

Captures use ``capture_error_mode="thread_local"``: the mesh runs one host
thread a device (``parallel.mesh._on_devices``), and in the default global
mode a capture on one card faults on the CUDA calls that another thread
makes for another card. The wrappers' launch counts (``ops._build``) add
up the same for a replay as for an eager run: a capture records its
launches with its graph and each replay adds them.

``fn`` must not write to its input tensors (they are the static buffers
in a replay) and must not read a device value on the host: a read
synchronises, and a synchronisation inside a capture raises. A host value
it computes (a Python float, a shape) is baked into the graph, so it may
depend only on the key.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from gps_optimize_slam_tpu_torch.ops import _build
from gps_optimize_slam_tpu_torch.utils import profiling

# Programs kept a device: a sequence-parallel run over four blocks of one
# card holds about thirty (seven stages a block and the folds).
MAX_PROGRAMS = 128
# Share of a card's memory that its held programs' static inputs and
# outputs may take; past it the least recently used programs are dropped.
MAX_HELD_SHARE = 0.125
# Keys a device remembers as called once (their next call captures).
MAX_SEEN = 1024

_LOCK = threading.Lock()
_DEVICES: Dict[torch.device, "_Device"] = {}
_STATS = {"first_calls": 0, "captures": 0, "replays": 0}
_EAGER = False
_LOCAL = threading.local()


class _Program(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]  # the static input buffers, in leaf order
    outputs: Any  # the capture's output tree; its tensors live in the device's pool
    launches: dict  # the kernel launches of one replay (ops._build.tally_launches)
    input_bytes: int
    output_bytes: int
    name: str = ""  # the function's name, for the tracer's spans and counters
    kernels: int = 0  # the graph's kernel nodes (-1 where they could not be counted)
    counts: Optional[dict] = None  # the host counts of one replay (utils.profiling.tally_counts)


class _Device:
    """A card's programs (least recently used first), the keys called
    once, the pool its programs share with the bytes its captures added to
    it, its capture stream, and the stream of its last replay."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.RLock()
        self.programs: "collections.OrderedDict[tuple, _Program]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
        self.pool = None
        self.pool_bytes = 0
        self.stream: Optional[torch.cuda.Stream] = None
        self.last: Optional[torch.cuda.Stream] = None


@contextlib.contextmanager
def eager():
    """Within it, ``run`` calls its function directly: eager dispatch, as
    under ``jax.disable_jit()``. For every thread of the process (the
    mesh's threads too); nests, and restores the state it found."""
    global _EAGER
    saved = _EAGER
    _EAGER = True
    try:
        yield
    finally:
        _EAGER = saved


def capturing() -> bool:
    """Whether this thread is capturing a program now. Code that would read
    a device value on the host to stop early (RANSAC's adaptive stop) runs
    its fixed schedule instead."""
    return getattr(_LOCAL, "capturing", False)


@contextlib.contextmanager
def _inside(capture: bool = False):
    """Within it this thread runs a program's body: a nested ``run`` is
    part of it and calls its function directly."""
    saved = getattr(_LOCAL, "inside", False), capturing()
    _LOCAL.inside, _LOCAL.capturing = True, capture
    try:
        yield
    finally:
        _LOCAL.inside, _LOCAL.capturing = saved


def _split(args, kwargs):
    """(the tree's leaves, its spec, its tensor leaves)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    return leaves, spec, [x for x in leaves if isinstance(x, torch.Tensor)]


def _key(fn, spec, leaves, tensors) -> tuple:
    static = tuple(None if isinstance(x, torch.Tensor) else x for x in leaves)
    return (fn, spec, static, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
            profiling.enabled())


def key_of(fn: Callable, *args, **kwargs) -> tuple:
    """The cache key of ``run(fn, *args, **kwargs)``: a program captured
    while the tracer is on (``utils.profiling``) holds its marks and device
    counters, so whether it is on is part of the key."""
    leaves, spec, tensors = _split(args, kwargs)
    return _key(fn, spec, leaves, tensors)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


def _count(name: str) -> None:
    with _LOCK:
        _STATS[name] += 1


def run(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: on a card, eagerly on the first call for
    the key, then its captured program replayed; on the CPU, inside
    ``eager()`` or inside another program, the call itself."""
    with profiling.span("graphs.key", fn):
        leaves, spec, tensors = _split(args, kwargs)
        devices = {t.device for t in tensors}
        direct = _EAGER or getattr(_LOCAL, "inside", False) or all(d.type != "cuda" for d in devices)
        if not direct and len(devices) == 1:
            key = _key(fn, spec, leaves, tensors)
    if direct:
        return fn(*args, **kwargs)
    if len(devices) > 1:
        raise ValueError(f"a captured program takes tensors on one device, got {sorted(map(str, devices))}")
    (device,) = devices
    with _LOCK:
        dev = _DEVICES.get(device) or _DEVICES.setdefault(device, _Device(device))
    with torch.cuda.device(device), dev.lock:
        program = dev.programs.get(key)
        if program is not None:
            dev.programs.move_to_end(key)
        elif key not in dev.seen:
            dev.seen[key] = None
            if len(dev.seen) > MAX_SEEN:
                dev.seen.popitem(last=False)
            _count("first_calls")
            with profiling.span("graphs.first_call", fn):
                return _first_call(dev, fn, args, kwargs)
        else:
            del dev.seen[key]
            with profiling.span("graphs.capture", fn):
                program = _capture(dev, fn, spec, leaves, tensors)
            _keep(dev, key, program)
            _count("captures")
        return _replay(dev, program, tensors)


def _capture_stream(dev: _Device) -> torch.cuda.Stream:
    if dev.stream is None:
        dev.stream = torch.cuda.Stream(dev.device)
    return dev.stream


def _first_call(dev: _Device, fn, args, kwargs):
    """A key's first call: ``fn`` eagerly on the capture stream, ordered
    after and before the caller's stream."""
    current = torch.cuda.current_stream(dev.device)
    stream = _capture_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.stream(stream), _inside():
        out = fn(*args, **kwargs)
    current.wait_stream(stream)
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(current)
    return out


def _capture(dev: _Device, fn, spec, leaves, tensors) -> _Program:
    """``fn`` captured on the capture stream into the device's shared pool,
    reading static buffers shaped as ``tensors`` (filled by each replay);
    its kernel nodes counted before the capture ends."""
    device = dev.device
    inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in tensors)
    it = iter(inputs)
    static_leaves = [next(it) if isinstance(x, torch.Tensor) else x for x in leaves]
    static_args, static_kwargs = pytree.tree_unflatten(static_leaves, spec)
    if not dev.programs:  # no graph holds the pool: start a new one
        dev.pool, dev.pool_bytes = torch.cuda.graph_pool_handle(), 0
    stream = _capture_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    reserved = torch.cuda.memory_reserved(device)
    lib = _build.library()
    with torch.cuda.stream(stream), _inside(capture=True), _build.tally_launches() as launches, \
            profiling.tally_counts() as counts:
        graph.capture_begin(pool=dev.pool, capture_error_mode="thread_local")
        try:
            outputs = fn(*static_args, **static_kwargs)
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the capture's own fault is the one to report
                graph.capture_end()
            raise
        kernels = int(lib.gps_capture_kernel_nodes(stream.cuda_stream))
        graph.capture_end()
    dev.pool_bytes += torch.cuda.memory_reserved(device) - reserved
    name = getattr(fn, "__name__", type(fn).__name__)
    return _Program(graph, inputs, outputs, launches, _nbytes(inputs), _nbytes(outputs), name, kernels, counts)


def _held_budget(device: torch.device) -> int:
    return int(MAX_HELD_SHARE * torch.cuda.get_device_properties(device).total_memory)


def _keep(dev: _Device, key, program: _Program) -> None:
    """Add ``program``, then drop the least recently used others while the
    device holds more than ``MAX_PROGRAMS`` or more bytes than its budget.
    A dropped program's outputs go back to the pool, for the next captures."""
    dev.programs[key] = program
    budget = _held_budget(dev.device)
    while len(dev.programs) > 1 and (
            len(dev.programs) > MAX_PROGRAMS
            or sum(p.input_bytes + p.output_bytes for p in dev.programs.values()) > budget):
        dev.programs.popitem(last=False)


def _replay(dev: _Device, program: _Program, tensors):
    """Copy ``tensors`` in, replay, add the capture's launches and return
    clones of the outputs, after the device's previous replay. Traced: the
    replay between two device marks, its kernel nodes added to the
    ``graph.kernels`` counter and the capture's host counts added."""
    current = torch.cuda.current_stream(dev.device)
    if dev.last is not None and dev.last != current:
        current.wait_stream(dev.last)
    with profiling.span("graphs.copy_in", program.name):
        for buf, t in zip(program.inputs, tensors):
            buf.copy_(t)
    with profiling.device_span("graphs.replay", dev.device), profiling.span("graphs.launch", program.name):
        program.graph.replay()
    _build.add_launches(program.launches)
    profiling.count("graph.kernels", program.kernels, program.name)
    profiling.add_counts(program.counts)
    with profiling.span("graphs.clone_out", program.name):
        out = pytree.tree_map_only(torch.Tensor, torch.clone, program.outputs)
    dev.last = current
    _count("replays")
    return out


def stats() -> dict:
    """First calls, captures and replays so far; the programs held, the
    bytes their captures added to the devices' pools, and their static
    inputs' and outputs' bytes, summed over the devices."""
    with _LOCK:
        devices = list(_DEVICES.values())
        out = dict(_STATS)
    programs = [p for d in devices for p in list(d.programs.values())]
    return {**out, "programs": len(programs), "pool_bytes": sum(d.pool_bytes for d in devices),
            "input_bytes": sum(p.input_bytes for p in programs),
            "output_bytes": sum(p.output_bytes for p in programs)}


def reset_stats() -> None:
    """Set the first-call, capture and replay counts to 0 (the programs
    stay)."""
    with _LOCK:
        _STATS.update(first_calls=0, captures=0, replays=0)


def clear() -> None:
    """Drop every program and every remembered key; the pools go back to
    the allocator's cache (``torch.cuda.empty_cache()`` frees them)."""
    with _LOCK:
        _DEVICES.clear()

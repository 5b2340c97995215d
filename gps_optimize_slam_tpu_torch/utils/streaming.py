"""Software-pipelined host↔device chunk streaming (port of
``gps_optimize_slam_tpu.utils.streaming``).

The out-of-core paths (``ops.kalman_chunked``, ``ops.alignment_chunked``,
``models.fusion_chunked``, ``models.robust``'s chunked gate and
``parallel.mesh``'s bucket sweep) move their data through the device one
chunk at a time. A naive loop

    stage → launch → drain → stage → launch → drain → …

serialises three things that can overlap: host-side staging of the NEXT
chunk (padding, then the copy to the device), device compute of the CURRENT
chunk, and the read-back of the PREVIOUS chunk's outputs. ``stream_chunks``
runs the same three callbacks one chunk apart, a double buffer. Kernel
launches still happen strictly in item order (the chunked scans thread
carries through ``launch``); only the host work slides.

On a card the copies overlap as JAX's ``device_put`` and ``np.asarray`` let
them: ``to_device`` copies host buffers pinned in page-locked memory on the
device's upload stream and has the compute stream wait for that copy on the
device, never on the host, so ``stage(i+1)`` returns while chunk i runs and
its copy runs beside chunk i's kernels. ``fetch``, called at the end of a
``launch``, marks the end of that chunk's work on the compute stream and
copies its outputs into pinned buffers on the download stream after that
mark; the handle's ``numpy()`` waits for that copy alone, so ``drain(i-1)``
returns without waiting for chunk i. Uploads and downloads take a stream
each (one a direction, a pair a device), so that a chunk's download does
not hold back the next chunk's upload: the card has a copy engine each
way. On the CPU both functions hand the arrays through as before.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_SENTINEL = object()


def stream_chunks(
    items: Iterable[Any],
    stage: Callable[[Any], Any],
    launch: Callable[[Any, Any], Any],
    drain: Optional[Callable[[Any, Any], None]],
) -> None:
    """Drive ``drain(i-1) ∥ launch(i) ∥ stage(i+1)`` over ``items``.

    * ``stage(item)``: host prep + transfer of one chunk's inputs
      (``to_device``). Called one item AHEAD of its launch (and before the
      previous item's drain).
    * ``launch(item, staged)``: enqueue the device work and its read-back
      (``fetch``); must NOT wait on results. Called strictly in item order,
      so carry chains (the re-entrant associative-scan elements) stay
      correct.
    * ``drain(item, launched)``: take the outputs on the host (``numpy()``
      of what ``fetch`` returned) and write them out. Called after the NEXT
      item's launch, so its wait overlaps that chunk's device compute.
      ``None`` skips draining.

    Equivalent to the naive loop for any callbacks without hidden ordering
    assumptions between a drain and the following stage/launch.
    """
    it = iter(items)
    item = next(it, _SENTINEL)
    staged = stage(item) if item is not _SENTINEL else None
    pending = None
    while item is not _SENTINEL:
        launched = launch(item, staged)
        nxt = next(it, _SENTINEL)
        staged = stage(nxt) if nxt is not _SENTINEL else None
        if pending is not None and drain is not None:
            drain(*pending)
        pending = (item, launched)
        item = nxt
    if pending is not None and drain is not None:
        drain(*pending)


class _CopyStreams(NamedTuple):
    upload: torch.cuda.Stream
    download: torch.cuda.Stream


_STREAMS: Dict[int, _CopyStreams] = {}
_LOCK = threading.Lock()


def _card(device) -> torch.device:
    """``device`` as a CUDA device with its index."""
    device = torch.device(device)
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def _copy_streams(device) -> _CopyStreams:
    """The upload and download streams of a card, made on first use."""
    device = _card(device)
    with _LOCK:
        streams = _STREAMS.get(device.index)
        if streams is None:
            streams = _STREAMS[device.index] = _CopyStreams(torch.cuda.Stream(device), torch.cuda.Stream(device))
    return streams


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def host_buffer(shape, dtype, device) -> torch.Tensor:
    """An empty host tensor for a stage to build a chunk in (through its
    ``.numpy()`` view) and hand to ``to_device``: pinned for a CUDA
    ``device``, so the copy starts from it with no bounce through pageable
    memory. ``dtype`` is a NumPy or torch dtype."""
    return torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=torch.device(device).type == "cuda")


def _pinned(a) -> torch.Tensor:
    """A pinned host tensor holding ``a``: ``a`` itself when it is one."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"to_device stages host data, got a tensor on {a.device}")
        if a.is_pinned():
            return a
        a = a.numpy()
    a = np.asarray(a)
    buf = host_buffer(a.shape, a.dtype, "cuda")
    np.copyto(buf.numpy(), a)
    return buf


def to_device(arrays: Sequence[Any], device) -> Tuple[torch.Tensor, ...]:
    """The host ``arrays`` (NumPy arrays, memmaps, or host tensors from
    ``host_buffer``) as tensors on ``device``.

    On a card each array is taken in a pinned tensor (a ``host_buffer``
    as it is, anything else copied into one) and copied with
    ``non_blocking=True`` on the card's upload stream, its device tensor
    allocated there; the current (compute) stream waits for the copies on
    the device, and each tensor is recorded on it, so the allocator keeps
    its block until the compute stream is done with it. PyTorch's caching
    host allocator recycles a pinned buffer only once its copy has ended.
    On the CPU, ``torch.as_tensor`` of each (no copy where it can share)."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.as_tensor(a, device=device) for a in arrays)
    device = _card(device)
    hosts = [_pinned(a) for a in arrays]
    upload = _copy_streams(device).upload
    compute = torch.cuda.current_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(upload):
        out = tuple(h.to(device, non_blocking=True) for h in hosts)
        copied = torch.cuda.Event()
        copied.record(upload)
    compute.wait_event(copied)
    for t in out:
        t.record_stream(compute)
    return out


class Fetched:
    """Host copies of device tensors under way (``fetch``). ``numpy()``
    waits for the copy of these tensors alone and returns NumPy arrays
    (on a card views of pinned host tensors, which stay pinned while a view
    lives: copy out what is kept, as writing into an output array does).

    On a card the three events, all timed, are ``ready`` (the compute
    stream after the work that made the tensors), ``started`` (the download
    stream once it has waited for ``ready``) and ``copied`` (after the
    copies): a download that waited for the next chunk's work shows as a
    ``started`` later than that chunk's ``ready``. They are None on the
    CPU, as is ``device`` (the card copied from). ``nbytes`` is the bytes
    copied."""

    def __init__(self, hosts, held=(), ready=None, started=None, copied=None, device=None):
        self.hosts = tuple(hosts)
        self._held = tuple(held)
        self.device = device
        self.ready, self.started, self.copied = ready, started, copied
        self.nbytes = sum(h.numel() * h.element_size() for h in self.hosts)

    def numpy(self) -> Tuple[np.ndarray, ...]:
        if self.copied is not None:
            self.copied.synchronize()
            self._held = ()
        return tuple(h.numpy() for h in self.hosts)


def fetch(tensors: Sequence[torch.Tensor]) -> Fetched:
    """Start copying ``tensors`` (on one device) to the host; call it at
    the end of a ``launch``, after the chunk's work is enqueued.

    On a card: each tensor made contiguous on the compute stream, an event
    recorded there, and the copies into pinned host tensors enqueued on the
    card's download stream after that event (the device tensors recorded
    on the download stream and held by the handle until the copy is done).
    Nothing waits on the host here. On the CPU the tensors themselves."""
    tensors = tuple(tensors)
    devices = {t.device for t in tensors}
    if all(d.type != "cuda" for d in devices):
        return Fetched(tensors)
    if len(devices) > 1:
        raise ValueError(f"fetch takes tensors on one device, got {sorted(map(str, devices))}")
    (device,) = devices
    compute = torch.cuda.current_stream(device)
    download = _copy_streams(device).download
    with torch.cuda.device(device):
        srcs = tuple(t.contiguous() for t in tensors)
        ready = torch.cuda.Event(enable_timing=True)
        ready.record(compute)
        hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in srcs)
        started, copied = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(download):
            download.wait_event(ready)
            started.record(download)
            for h, s in zip(hosts, srcs):
                h.copy_(s, non_blocking=True)
            copied.record(download)
    for s in srcs:
        s.record_stream(download)
    return Fetched(hosts, srcs, ready, started, copied, device)

"""Software-pipelined host↔device chunk streaming (port of
``gps_optimize_slam_tpu.utils.streaming``).

The out-of-core paths (``ops.kalman_chunked``, ``ops.alignment_chunked``,
``models.fusion_chunked``) move a trajectory through the device one chunk at
a time. PyTorch's CUDA operations are asynchronous: a launch returns at
once, and only a read back to the host (``.cpu()``) waits. A naive loop

    stage → launch → drain → stage → launch → drain → …

serialises three things that can overlap: host-side staging of the NEXT
chunk (padding + ``torch.as_tensor(..., device=device)``), device compute
of the CURRENT chunk, and the host read-back of the PREVIOUS chunk's
outputs. ``stream_chunks`` runs the same three callbacks one chunk apart, a
double buffer. Kernel launches still happen strictly in item order (the
chunked scans thread carries through ``launch``); only the host work
slides. Staging copies from pageable host memory on the current stream;
pinned buffers and a copy stream are later work.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

_SENTINEL = object()


def stream_chunks(
    items: Iterable[Any],
    stage: Callable[[Any], Any],
    launch: Callable[[Any, Any], Any],
    drain: Optional[Callable[[Any, Any], None]],
) -> None:
    """Drive ``drain(i-1) ∥ launch(i) ∥ stage(i+1)`` over ``items``.

    * ``stage(item)``: host prep + transfer of one chunk's inputs. Called one
      item AHEAD of its launch (and before the previous item's drain).
    * ``launch(item, staged)``: enqueue the device work; must NOT wait on
      results. Called strictly in item order, so carry chains (the
      re-entrant associative-scan elements) stay correct.
    * ``drain(item, launched)``: pull outputs to the host and write them
      out. Called after the NEXT item's launch, so the blocking read
      overlaps that chunk's device compute. ``None`` skips draining.

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

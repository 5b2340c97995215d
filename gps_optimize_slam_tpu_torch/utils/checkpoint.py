"""Checkpoint and resume (port of ``gps_optimize_slam_tpu.utils.checkpoint``,
which writes with orbax; orbax is not a dependency of the port).

A checkpoint is a directory: ``<dir>/state``, a ``torch.save`` of the state
as nested dicts and lists of CPU tensors and plain Python values, with a
copy of the metadata beside it, and ``<dir>/metadata.json``, written last,
so its presence marks a complete checkpoint. Each file is written to a
temporary name and renamed into place. The metadata returned on restore is
the copy in the state file, so one rename commits a state and its metadata
together: a run killed between the two renames of a rewrite leaves the new
state and its own metadata beside the old ``metadata.json``, and restores
the new round. NamedTuples are stored as dicts, as the JAX package stores them;
``restore_checkpoint`` rebuilds the caller's containers from a target of the
same structure. The state is read with ``torch.load(weights_only=True)``:
no pickled code runs. Checkpoints written by the JAX package (orbax) are not
read, nor are these by it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _to_saved(x: Any) -> Any:
    """The state as nested dicts and lists of CPU tensors (NamedTuples as
    dicts; NumPy arrays and tensors on any device as CPU tensors)."""
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: _to_saved(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _to_saved(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_saved(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def _like(target: Any, saved: Any) -> Any:
    """``saved`` rebuilt in ``target``'s NamedTuples and dicts; a tensor leaf
    goes to the target leaf's device, a NumPy leaf back to NumPy, any other
    leaf (a list, a number) as saved."""
    if isinstance(target, tuple) and hasattr(target, "_asdict"):
        return type(target)(**{k: _like(v, saved[k]) for k, v in target._asdict().items()})
    if isinstance(target, dict):
        return {k: _like(v, saved[k]) for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        return saved.to(target.device)
    if isinstance(target, (np.ndarray, np.generic)):
        return saved.numpy()
    return saved


def save_checkpoint(path: str, state: Any, metadata: Optional[dict] = None) -> None:
    """Persist ``state`` (tensors, NumPy arrays, NamedTuples, dicts and lists
    of them) and ``metadata`` (JSON values) to the directory ``path``: the
    state file with the metadata inside, then ``metadata.json``, each
    written to a temporary name and renamed, so a reader never sees half of
    either."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    text = None if metadata is None else json.dumps(metadata, indent=2, default=str)
    tmp = os.path.join(path, "state.tmp")
    torch.save({"state": _to_saved(state), "metadata": None if text is None else json.loads(text)}, tmp)
    os.replace(tmp, os.path.join(path, "state"))
    if text is not None:
        tmp = os.path.join(path, "metadata.json.tmp")
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(path, "metadata.json"))


def restore_checkpoint_untyped(path: str) -> Tuple[Any, Optional[dict]]:
    """Restore a checkpoint without a target: the state as saved, NamedTuples
    as dicts and every array a CPU tensor; callers rebuild typed containers
    (see ``parallel.mesh.fuse_buckets_checkpointed``). Returns (state,
    metadata or None), the metadata saved with this state."""
    saved = torch.load(os.path.join(os.path.abspath(path), "state"), map_location="cpu", weights_only=True)
    return saved["state"], saved["metadata"]


def restore_checkpoint(path: str, target: Any) -> Tuple[Any, Optional[dict]]:
    """Restore a state saved by ``save_checkpoint`` into the structure of
    ``target`` (the same containers; its leaves give each restored leaf's
    kind and device). Returns (state, metadata or None)."""
    state, metadata = restore_checkpoint_untyped(path)
    return _like(target, state), metadata

"""The one traffic generator of the benchmark: it reads a mix's parameters
(``traffic/<name>.json``) and a seed, and makes the host arrays of each
request variant. Every stream is real-derived: replicas of the KITTI
odometry seq-04 SLAM trajectory and its GNSS fixes (``data/seq04_golden.npz``,
the reference implementation's own arrays), with fresh GNSS noise drawn from
the seed.

A mix's ``kind`` names the module ``traffic/kinds/<kind>.py`` whose
``drives(params, rng)`` makes one request's drives (``fleet``: one drive at
each of the given lengths; ``shuttle``: one drive over one road, forward and
back). A new kind is a new module there.

Every variant of a mix has the same shapes; variants differ in their noise.
A drive is ``(slam, gps_times, gps_positions)``: ``slam`` a dict of
``timestamps`` (N,), ``positions`` (N, 3), ``quaternions`` (N, 4) xyzw; the
GNSS in a local frame (UTM minus the golden track's first fix), float64.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(os.path.dirname(HERE), "data", "seq04_golden.npz")


@functools.lru_cache(maxsize=1)
def golden():
    """The seq-04 arrays: SLAM times, positions and quaternions, GNSS times
    and UTM positions, and the reference's Sim(3) scale and rotation."""
    g = np.load(GOLDEN)
    return {k: g[k] for k in ("slam_times", "slam_pos", "slam_quat", "gps_times", "gps_utm", "sim3_scale", "sim3_R")}


def load(name: str) -> dict:
    """The parameters of the mix ``traffic/<name>.json``."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def kind_module(kind: str):
    """The module ``traffic/kinds/<kind>.py`` of a mix's ``kind``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(kind)) or \
            not os.path.isfile(os.path.join(HERE, "kinds", f"{kind}.py")):
        raise ValueError(f"unknown kind of traffic mix: {kind!r}")
    return importlib.import_module(f"portbench.traffic.kinds.{kind}")


def drives(params: dict, rng: np.random.Generator) -> list:
    """One request's drives under the mix ``params``, noise from ``rng``."""
    return kind_module(params["kind"]).drives(params, rng)


def requests(params: dict, seed: int) -> list:
    """``params["variants"]`` requests, each a list of drives, from ``seed``
    (any non-negative whole number), and one RANSAC seed a drive (below
    2**31): ``[(drives, seeds)]``."""
    root = np.random.default_rng(int(seed))
    out = []
    for _ in range(int(params["variants"])):
        rng = np.random.default_rng(root.integers(0, 2**63 - 1))
        ds = drives(params, rng)
        out.append((ds, [int(s) for s in rng.integers(0, 2**31 - 1, size=len(ds))]))
    return out


def real_poses(request) -> int:
    """The real (unpadded) SLAM poses of a request."""
    return sum(len(slam["timestamps"]) for slam, _, _ in request[0])

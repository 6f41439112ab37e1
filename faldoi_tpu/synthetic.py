"""A seeded frame pair at Sintel shape whose flow is known exactly.

I1 is a procedural RGB texture T: a seeded sum of band-limited plane
waves (periods 4-64 px), squashed into [0, 255] and rounded to 8 bits like
a PNG frame.  I0(x) = T(x + u(x)) is the same texture evaluated
analytically at the displaced positions, where u is the committed MPI-Sintel
ground truth ``tests/golden/gt_easy.flo`` (436x1024, clean/easy frame 2),
so u is the true flow from I0 to I1 up to 8-bit rounding and nothing has
to be downloaded.

Seeds sit where DeepMatching put its matches on that frame
(``tests/golden/deep_mt_1.txt``, 1,703 matches): forward seeds carry the
known flow, backward seeds the negated flow at the displaced positions.
Both are 4-column match lists ``x0 y0 x1 y1`` rasterised by
``core.sparse``, the same path the ``sparse_flow`` driver takes.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from faldoi_tpu.core.sparse import parse_matches, sparse_flow_from_matches
from faldoi_tpu.io.flo import read_flo

_GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden")
FLOW_PATH = os.path.join(_GOLDEN, "gt_easy.flo")
MATCHES_PATH = os.path.join(_GOLDEN, "deep_mt_1.txt")
SHAPE = (436, 1024)

_N_WAVES = 48


class Pair(NamedTuple):
    i0: np.ndarray           # (3, h, w) float32 planar RGB, 0..255
    i1: np.ndarray
    flow: np.ndarray         # (h, w, 2) float32 known flow I0 -> I1
    matches_fwd: np.ndarray  # (n, 4) float32 x0 y0 x1 y1
    matches_bwd: np.ndarray
    seeds_fwd: np.ndarray    # (h, w, 2) NaN-sparse seed fields
    seeds_bwd: np.ndarray


def texture(x: np.ndarray, y: np.ndarray, seed: int) -> np.ndarray:
    """The seeded RGB texture at real coordinates (x, y): (3,) + x.shape
    float64 in [0, 255]."""
    rng = np.random.RandomState(seed)
    period = np.exp(rng.uniform(np.log(4.0), np.log(64.0), _N_WAVES))
    theta = rng.uniform(0.0, np.pi, _N_WAVES)
    phase = rng.uniform(0.0, 2.0 * np.pi, _N_WAVES)
    amp = np.sqrt(period / 64.0)
    mix = rng.uniform(0.2, 1.0, (3, _N_WAVES)) * amp
    kx = 2.0 * np.pi * np.cos(theta) / period
    ky = 2.0 * np.pi * np.sin(theta) / period
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    acc = np.zeros((3,) + x.shape)
    for k in range(_N_WAVES):
        acc += mix[:, k, None, None] * np.cos(kx[k] * x + ky[k] * y + phase[k])
    scale = np.sqrt(0.5 * (mix ** 2).sum(axis=1))[:, None, None]
    return 127.5 * (1.0 + np.tanh(acc / (1.5 * scale)))


def make_pair(seed: int = 0,
              crop: Optional[Tuple[int, int, int, int]] = None) -> Pair:
    """Build the pair from ``seed``.  ``crop=(y0, x0, h, w)`` cuts a window
    of the full 436x1024 frame (frames, flow and seeds alike); the texture
    is evaluated in full-frame coordinates, so a crop is exactly the
    corresponding part of the full pair."""
    flow_full = read_flo(FLOW_PATH)
    y0, x0, h, w = crop if crop is not None else (0, 0) + SHAPE
    flow = np.ascontiguousarray(flow_full[y0:y0 + h, x0:x0 + w])
    yy, xx = np.mgrid[y0:y0 + h, x0:x0 + w].astype(np.float64)
    i1 = np.rint(texture(xx, yy, seed)).astype(np.float32)
    i0 = np.rint(texture(xx + flow[..., 0], yy + flow[..., 1],
                         seed)).astype(np.float32)

    pos = parse_matches(MATCHES_PATH)[:, :2].astype(np.int64)
    inside = ((pos[:, 0] >= x0) & (pos[:, 0] < x0 + w)
              & (pos[:, 1] >= y0) & (pos[:, 1] < y0 + h))
    pos = pos[inside] - np.array([x0, y0])
    px = pos[:, 0].astype(np.float32)
    py = pos[:, 1].astype(np.float32)
    fu = flow[pos[:, 1], pos[:, 0], 0]
    fv = flow[pos[:, 1], pos[:, 0], 1]
    fwd = np.stack([px, py, px + fu, py + fv], axis=1)
    bwd = np.stack([px + fu, py + fv, px, py], axis=1)
    return Pair(i0, i1, flow, fwd, bwd,
                sparse_flow_from_matches(fwd, w, h),
                sparse_flow_from_matches(bwd, w, h))


def write_matches(path: str, matches: np.ndarray) -> None:
    """Write a 4-column match list that parses back to the same float32
    values."""
    with open(path, "w") as fh:
        for row in np.asarray(matches, np.float32):
            fh.write(" ".join(repr(float(v)) for v in row) + "\n")


def epe(flow: np.ndarray, ref: np.ndarray) -> float:
    """Mean endpoint error over pixels finite in both fields."""
    fin = np.isfinite(flow[..., 0]) & np.isfinite(ref[..., 0])
    return float(np.hypot(flow[..., 0] - ref[..., 0],
                          flow[..., 1] - ref[..., 1])[fin].mean())

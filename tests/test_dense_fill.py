"""Oracle for the default ``fill="dense"`` deviation.

``_dense_fill`` (core/local_step.py) replaces the reference's per-patch
Poisson interpolation (``interpolate_poisson``, local_faldoi.cpp:326-368 /
elap_recsep.c) with one whole-image masked diffusion per sweep.  The claim
backing the default is that *at frontier patches* — where the growing
actually solves — the two fills agree, because both extrapolate the same
nearby fixed pixels.  This test quantifies that claim on realistic frontier
geometries (half-plane fronts, blob fronts, smooth + discontinuous flow).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.core.local_step import _dense_fill
from faldoi_tpu.ops.poisson import poisson_fill_canvas

P = 11  # patch size (2*wr+1, wr=5 default)


def _patch_fills(fixed, vals, cy, cx):
    """Returns (dense_fill_patch, poisson_patch, fixed_patch) at (cy, cx)."""
    h, w = fixed.shape
    dense = np.asarray(_dense_fill(jnp.asarray(fixed), jnp.asarray(vals)))
    oy = min(max(cy - P // 2, 0), h - P)
    ox = min(max(cx - P // 2, 0), w - P)
    fx = fixed[oy:oy + P, ox:ox + P]
    vp = vals[oy:oy + P, ox:ox + P]
    canvas = np.where(fx, vp, np.nan)
    pois = np.asarray(poisson_fill_canvas(jnp.asarray(canvas), P, P))
    return dense[oy:oy + P, ox:ox + P], pois, fx, vp


def _frontier_cells(fx):
    """Non-fixed cells 4-adjacent to a fixed cell — where candidates live."""
    pad = np.pad(fx, 1)
    nb = (pad[:-2, 1:-1] | pad[2:, 1:-1] | pad[1:-1, :-2] | pad[1:-1, 2:])
    return ~fx & nb


def test_dense_fill_reaches_far_patch_corners_of_isolated_seed():
    """Sparse-seed regression guard: a single fixed pixel must propagate to
    the far corners of ANY candidate patch around it (the reference's
    per-patch Poisson fill carries the seed value across the whole patch —
    interpolate_poisson, local_faldoi.cpp:326-368).  With too few diffusion
    iterations those corners stay 0 and the PD solve starts from garbage."""
    h, w = 64, 96
    fixed = np.zeros((h, w), bool)
    fixed[32, 48] = True
    vals = np.where(fixed, 7.5, 0.0).astype(np.float32)
    dense = np.asarray(_dense_fill(jnp.asarray(fixed), jnp.asarray(vals)))
    # candidate at (33, 48); its wr=5 patch spans rows 28..38, cols 43..53;
    # also check one ring further (candidates at distance 2 after a sweep)
    for (cy, cx) in [(33, 48), (34, 48), (32, 50)]:
        oy, ox = cy - 5, cx - 5
        patch = dense[oy:oy + P, ox:ox + P]
        assert np.abs(patch - 7.5).max() < 1e-4, (
            f"patch at {(cy, cx)}: fill did not reach corners "
            f"(min {patch.min()})"
        )


@pytest.mark.parametrize("geometry", ["half_plane", "blob", "two_fronts"])
def test_dense_fill_matches_poisson_at_frontier(geometry):
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    vals = 0.05 * xx - 0.03 * yy + 2.0  # smooth flow field
    fixed = np.zeros((h, w), bool)
    if geometry == "half_plane":
        fixed[:, :40] = True
        centers = [(20, 41), (45, 41)]
    elif geometry == "blob":
        fixed[(yy - 30) ** 2 + (xx - 45) ** 2 < 15 ** 2] = True
        centers = [(30, 61), (14, 45)]
    else:  # two fronts with DIFFERENT flows meeting (discontinuity)
        fixed[:, :25] = True
        fixed[:, 70:] = True
        vals[:, 47:] += 4.0  # 4-px jump between the fronts
        centers = [(32, 26), (32, 69)]

    vals = np.where(fixed, vals, 0.0).astype(np.float32)
    for cy, cx in centers:
        dense, pois, fx, vp = _patch_fills(fixed, vals, cy, cx)
        cells = _frontier_cells(fx)
        assert cells.any()
        diff = np.abs(dense - pois)[cells]
        # frontier cells: both fills extrapolate the adjacent fixed pixels
        assert diff.max() < 0.30, (
            f"{geometry} frontier fill divergence {diff.max():.3f}"
        )
        # and the values the PD solve warm-starts from stay close to the
        # local fixed flow (no wild extrapolation)
        near = np.abs(dense[cells] - np.median(vp[fx]))
        assert near.max() < 6.0

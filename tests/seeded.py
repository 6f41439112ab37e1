"""Seeded stand-ins for the real frames the tests used to read: crops of
the Sintel-shape pair of ``faldoi_tpu.synthetic`` with its known flow."""

import numpy as np

from faldoi_tpu.synthetic import make_pair, texture

SEED = 0


def pair(crop):
    """(i0, i1, flow) planar RGB frames and known flow on ``crop``."""
    p = make_pair(SEED, crop)
    return p.i0, p.i1, p.flow


def quad(crop):
    """(I0, I1, I-1, I2) for the 4-frame occlusion functional under
    constant motion: I-1(x) = T(x + 2u), I2(x) = T(x - u)."""
    i0, i1, flow = pair(crop)
    y0, x0, h, w = crop
    yy, xx = np.mgrid[y0:y0 + h, x0:x0 + w].astype(np.float64)
    u, v = flow[..., 0], flow[..., 1]
    i_1 = np.rint(texture(xx + 2 * u, yy + 2 * v, SEED)).astype(np.float32)
    i2 = np.rint(texture(xx - u, yy - v, SEED)).astype(np.float32)
    return i0, i1, i_1, i2, flow

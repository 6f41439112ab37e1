"""Bicubic (Catmull-Rom-style) sampling and warping.

Dense formulation of ``src/bicubic_interpolation.c`` with the reference's
exact semantics (verified element-wise against a C-transliteration oracle):

* integer positions via C ``(int)`` casts (truncation toward zero, not floor),
* the 4x4 stencil is laid out around the truncated point using sign steps
  ``sx = sign(uu)``, ``sy = sign(vv)`` (bicubic_interpolation.c:146-163),
* *including* the reference's quirk that the ``my`` row index uses ``sx``
  instead of ``sy`` (bicubic_interpolation.c:159),
* Neumann clamping with an "out of domain" flag; ``border_out=True`` returns
  0 there, ``border_out=False`` extrapolates with the clamped stencil,
* interpolation fractions are ``uu - x_clamped``.

Instead of 16 independent point gathers, each sample fetches ONE
contiguous 4x4 window with ``lax.gather`` (4x4xC for channels-last stacks,
so planes warped by the same flow share one gather) that holds all of its
Neumann-clamped stencil taps, picks the 16 taps out of it by selects
(duplicated edge taps included) and evaluates the reference's cubic in
the same Horner form and order.  The arithmetic is plain float32: no
matrix unit and no reduced precision.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax


def _cubic(v, t):
    """cubic_interpolation_cell (bicubic_interpolation.c:103-111) in its
    Horner form: duplicated (clamped) taps cancel exactly, so samples far
    outside the image stay exact."""
    return v[1] + 0.5 * t * (v[2] - v[0] + t * (
        2.0 * v[0] - 5.0 * v[1] + 4.0 * v[2] - v[3]
        + t * (3.0 * (v[1] - v[2]) + v[3] - v[0])))


def _gather_windows(img, wy, wx):
    """Gather (..., 4, 4, *chans) windows from img (h, w, *chans) at integer
    starts (wy, wx)."""
    idx = jnp.stack([wy, wx], axis=-1).reshape(-1, 2)
    chans = img.shape[2:]
    dn = lax.GatherDimensionNumbers(
        offset_dims=tuple(range(1, 3 + len(chans))),
        collapsed_slice_dims=(),
        start_index_map=(0, 1),
    )
    wins = lax.gather(
        img, idx, dn, slice_sizes=(4, 4) + chans,
        mode=lax.GatherScatterMode.CLIP,
    )
    return wins.reshape(wy.shape + (4, 4) + chans)


def _stencil(ny: int, nx: int, uu: jnp.ndarray, vv: jnp.ndarray):
    """Per-sample stencil geometry: the 4x4 window starts (wy, wx), the
    window-relative offsets of the reference's stencil rows
    [my, y, dy, ddy] and columns [mx, x, dx, ddx] (clamped to the image,
    duplicates kept), the fractions (vv - y, uu - x) and the out-of-domain
    flag.  The clamped taps of one axis always lie in one 4-window."""
    sx = jnp.where(uu < 0, -1, 1).astype(jnp.int32)
    sy = jnp.where(vv < 0, -1, 1).astype(jnp.int32)
    iu = uu.astype(jnp.int32)  # C (int) cast: truncation toward zero
    iv = vv.astype(jnp.int32)

    def taps(ps, n):
        out = jnp.zeros(iu.shape, bool)
        cl = []
        for p in ps:
            out = out | (p < 0) | (p >= n)
            cl.append(jnp.clip(p, 0, n - 1))
        start = jnp.clip(functools.reduce(jnp.minimum, cl), 0,
                         max(n - 4, 0))
        return start, [c - start for c in cl], cl[1], out

    wx, rx, x, ox = taps([iu - sx, iu, iu + sx, iu + 2 * sx], nx)
    # sic: the 'my' row uses sx (bicubic_interpolation.c:159)
    wy, ry, y, oy = taps([iv - sx, iv, iv + sy, iv + 2 * sy], ny)
    return wy, wx, ry, rx, vv - y.astype(vv.dtype), uu - x.astype(uu.dtype), \
        ox | oy


def _pick(vals, rel):
    """vals[rel] for a per-sample offset rel in [0, 4), by selects (no
    arithmetic: a NaN elsewhere in the window does not leak in)."""
    return jnp.where(rel == 0, vals[0], jnp.where(
        rel == 1, vals[1], jnp.where(rel == 2, vals[2], vals[3])))


def bicubic_interp_at(img: jnp.ndarray, uu: jnp.ndarray, vv: jnp.ndarray,
                      border_out: bool):
    """Sample ``img`` at positions (x=uu, y=vv).

    ``img`` is one plane (h, w) -> result ``uu.shape``, or a channels-last
    stack (h, w, C) sampled at the same positions -> ``uu.shape + (C,)``."""
    ny, nx = img.shape[:2]
    wy, wx, ry, rx, fy, fx, out = _stencil(ny, nx, uu, vv)

    wins = _gather_windows(img, wy, wx)  # (..., 4 rows, 4 cols, *chans)
    if img.ndim == 3:
        wins = jnp.moveaxis(wins, -1, -3)  # (..., C, 4, 4)
        ry, rx = [a[..., None] for a in ry], [a[..., None] for a in rx]
        fy, fx, out = fy[..., None], fx[..., None], out[..., None]
    # window rows sampled at the four stencil columns, then each stencil
    # column interpolated down its stencil rows (the reference's order)
    at_cols = [[_pick([wins[..., a, b] for b in range(4)], rx[l])
                for l in range(4)] for a in range(4)]
    cols = [_cubic([_pick([at_cols[a][l] for a in range(4)], ry[k])
                    for k in range(4)], fy) for l in range(4)]
    r = _cubic(cols, fx)

    if border_out:
        r = jnp.where(out, 0.0, r)
    return r


def bicubic_out_flag(ny: int, nx: int, uu: jnp.ndarray, vv: jnp.ndarray):
    """The reference's out-of-domain flag (bicubic_interpolation_at,
    bicubic_interpolation.c:146-163, incl. the row quirk) for GLOBAL
    coordinates — for callers that sample from a band whose edges are not
    the image border (the spatially-sharded warp)."""
    sx = jnp.where(uu < 0, -1, 1).astype(jnp.int32)
    sy = jnp.where(vv < 0, -1, 1).astype(jnp.int32)
    iu = uu.astype(jnp.int32)
    iv = vv.astype(jnp.int32)
    out = jnp.zeros(uu.shape, bool)
    for p in (iu - sx, iu, iu + sx, iu + 2 * sx):
        out = out | (p < 0) | (p >= nx)
    for p in (iv - sx, iv, iv + sy, iv + 2 * sy):
        out = out | (p < 0) | (p >= ny)
    return out


def bicubic_warp(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                 border_out: bool) -> jnp.ndarray:
    """Warp a whole image by the flow (u, v): out[i,j] = img(j+u, i+v)
    (bicubic_interpolation.c:245-266)."""
    ny, nx = img.shape
    jj = jnp.arange(nx, dtype=img.dtype)[None, :]
    ii = jnp.arange(ny, dtype=img.dtype)[:, None]
    return bicubic_interp_at(img, jj + u, ii + v, border_out)


def bicubic_warp_stack(planes: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                       border_out: bool) -> jnp.ndarray:
    """Warp (C, ny, nx) stacked planes by one flow: one 4x4xC window gather
    per pixel shared by all planes.  Returns (C, ny, nx)."""
    _, ny, nx = planes.shape
    jj = jnp.arange(nx, dtype=planes.dtype)[None, :]
    ii = jnp.arange(ny, dtype=planes.dtype)[:, None]
    out = bicubic_interp_at(jnp.moveaxis(planes, 0, -1), jj + u, ii + v,
                            border_out)
    return jnp.moveaxis(out, -1, 0)

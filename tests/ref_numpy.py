"""Independent NumPy transliterations of the reference C semantics.

These are straight ports of the scalar loops (mask.c, bicubic_interpolation.c,
utils.cpp, elap_recsep.c) used ONLY as test oracles for the JAX kernels; the
production code never imports this module.
"""

from __future__ import annotations

import math

import numpy as np


def forward_gradient(f):
    ny, nx = f.shape
    fx = np.zeros_like(f)
    fy = np.zeros_like(f)
    fx[:, :-1] = f[:, 1:] - f[:, :-1]
    fy[:-1, :] = f[1:, :] - f[:-1, :]
    fx[:, -1] = 0
    fy[-1, :] = 0
    return fx, fy


def backward_gradient(f):
    fx = np.zeros_like(f)
    fy = np.zeros_like(f)
    fx[:, 1:] = f[:, 1:] - f[:, :-1]
    fy[1:, :] = f[1:, :] - f[:-1, :]
    return fx, fy


def centered_gradient(f):
    ny, nx = f.shape
    dx = np.zeros_like(f)
    dy = np.zeros_like(f)
    dx[:, 1:-1] = 0.5 * (f[:, 2:] - f[:, :-2])
    dx[:, 0] = 0.5 * (f[:, 1] - f[:, 0])
    dx[:, -1] = 0.5 * (f[:, -1] - f[:, -2])
    dy[1:-1, :] = 0.5 * (f[2:, :] - f[:-2, :])
    dy[0, :] = 0.5 * (f[1, :] - f[0, :])
    dy[-1, :] = 0.5 * (f[-1, :] - f[-2, :])
    return dx, dy


def divergence(v1, v2):
    ny, nx = v1.shape
    div = np.zeros_like(v1)
    # interior
    div[1:-1, 1:-1] = (v1[1:-1, 1:-1] - v1[1:-1, :-2]) + (v2[1:-1, 1:-1] - v2[:-2, 1:-1])
    # first/last rows (interior cols)
    div[0, 1:-1] = v1[0, 1:-1] - v1[0, :-2] + v2[0, 1:-1]
    div[-1, 1:-1] = v1[-1, 1:-1] - v1[-1, :-2] - v2[-2, 1:-1]
    # first/last cols (interior rows)
    div[1:-1, 0] = v1[1:-1, 0] + v2[1:-1, 0] - v2[:-2, 0]
    div[1:-1, -1] = -v1[1:-1, -2] + v2[1:-1, -1] - v2[:-2, -1]
    # corners
    div[0, 0] = v1[0, 0] + v2[0, 0]
    div[0, -1] = -v1[0, -2] + v2[0, -1]
    div[-1, 0] = v1[-1, 0] - v2[-2, 0]
    div[-1, -1] = -v1[-1, -2] - v2[-2, -1]
    return div


def forward_gradient_patch(f, ii, ij, ei, ej):
    """utils.cpp:175-220 — on the patch box [ij,ej) x [ii,ei); box edges act
    as image edges. Only patch entries are touched."""
    fx = np.zeros_like(f)
    fy = np.zeros_like(f)
    fx[ij:ej, ii : ei - 1] = f[ij:ej, ii + 1 : ei] - f[ij:ej, ii : ei - 1]
    fy[ij : ej - 1, ii:ei] = f[ij + 1 : ej, ii:ei] - f[ij : ej - 1, ii:ei]
    fx[ij:ej, ei - 1] = 0
    fy[ej - 1, ii:ei] = 0
    return fx, fy


def divergence_patch_intended(v1, v2, ii, ij, ei, ej):
    """Chambolle divergence on the patch box with the box treated as the image
    domain. This is the *intended* semantics; the reference's code
    (utils.cpp:90-105) writes its row-0/col-0 boundary cases to absolute image
    coordinates, leaving stale values on interior-patch edges — we implement
    the intent (see faldoi_tpu/ops/stencils.py docstring)."""
    div = np.zeros_like(v1)
    p1 = v1[ij:ej, ii:ei]
    p2 = v2[ij:ej, ii:ei]
    div[ij:ej, ii:ei] = divergence(p1, p2)
    return div


def gaussian(I, sigma):
    """mask.c:248-357, REFLECTING boundary."""
    ydim, xdim = I.shape
    I = I.copy()
    size = int(5 * sigma) + 1
    den = 2.0 * sigma * sigma
    B = np.array(
        [1 / (sigma * math.sqrt(2.0 * 3.1415926)) * math.exp(-i * i / den) for i in range(size)],
        dtype=np.float32,
    )
    norm = np.float32(2 * B.sum(dtype=np.float32) - B[0])
    B = (B / norm).astype(np.float32)

    bdx = xdim + size
    # rows
    for k in range(ydim):
        R = np.zeros(size + xdim + size, dtype=np.float32)
        R[size:bdx] = I[k, :]
        for i in range(size):
            R[i] = I[k, size - i]
            R[bdx + i] = I[k, xdim - i - 1]
        for i in range(size, bdx):
            s = B[0] * R[i]
            for j in range(1, size):
                s += B[j] * (R[i - j] + R[i + j])
            I[k, i - size] = s
    bdy = ydim + size
    # cols
    for k in range(xdim):
        T = np.zeros(size + ydim + size, dtype=np.float32)
        T[size:bdy] = I[:, k]
        for i in range(size):
            T[i] = I[size - i, k]
            T[bdy + i] = I[ydim - i - 1, k]
        for i in range(size, bdy):
            s = B[0] * T[i]
            for j in range(1, size):
                s += B[j] * (T[i - j] + T[i + j])
            I[i - size, k] = s
    return I


def _neumann(x, n):
    out = False
    if x < 0:
        x = 0
        out = True
    elif x >= n:
        x = n - 1
        out = True
    return x, out


def _cubic(v, x):
    return v[1] + 0.5 * x * (
        v[2] - v[0] + x * (2.0 * v[0] - 5.0 * v[1] + 4.0 * v[2] - v[3] + x * (3.0 * (v[1] - v[2]) + v[3] - v[0]))
    )


def bicubic_at(img, uu, vv, border_out):
    """bicubic_interpolation.c:138-237, Neumann BC, incl. the my/sx quirk."""
    ny, nx = img.shape
    sx = -1 if uu < 0 else 1
    sy = -1 if vv < 0 else 1
    o = False
    x, t = _neumann(int(uu), nx); o |= t
    y, t = _neumann(int(vv), ny); o |= t
    mx, t = _neumann(int(uu) - sx, nx); o |= t
    my, t = _neumann(int(vv) - sx, ny); o |= t  # sic: sx
    dx, t = _neumann(int(uu) + sx, nx); o |= t
    dy, t = _neumann(int(vv) + sy, ny); o |= t
    ddx, t = _neumann(int(uu) + 2 * sx, nx); o |= t
    ddy, t = _neumann(int(vv) + 2 * sy, ny); o |= t
    if o and border_out:
        return np.float32(0.0)
    cols = []
    for cx in (mx, x, dx, ddx):
        v = [img[my, cx], img[y, cx], img[dy, cx], img[ddy, cx]]
        cols.append(_cubic(v, vv - y))
    return np.float32(_cubic(cols, uu - x))


def bicubic_at_vec(img, uu, vv, border_out):
    """``bicubic_at`` over arrays of positions at once, in float64: the
    same stencil, Neumann clamps and my/sx quirk, vectorised so that
    whole frames can be checked."""
    img = np.asarray(img, np.float64)
    uu = np.asarray(uu, np.float64)
    vv = np.asarray(vv, np.float64)
    ny, nx = img.shape
    sx = np.where(uu < 0, -1, 1)
    sy = np.where(vv < 0, -1, 1)
    iu = np.trunc(uu).astype(np.int64)
    iv = np.trunc(vv).astype(np.int64)
    out = np.zeros(uu.shape, bool)

    def neumann(p, n):
        nonlocal out
        out = out | (p < 0) | (p >= n)
        return np.clip(p, 0, n - 1)

    x = neumann(iu, nx)
    y = neumann(iv, ny)
    mx = neumann(iu - sx, nx)
    my = neumann(iv - sx, ny)  # sic: sx
    dx = neumann(iu + sx, nx)
    dy = neumann(iv + sy, ny)
    ddx = neumann(iu + 2 * sx, nx)
    ddy = neumann(iv + 2 * sy, ny)
    cols = [_cubic([img[my, cx], img[y, cx], img[dy, cx], img[ddy, cx]],
                   vv - y) for cx in (mx, x, dx, ddx)]
    r = _cubic(cols, uu - x)
    if border_out:
        r = np.where(out, 0.0, r)
    return r


def bicubic_warp(img, u, v, border_out):
    ny, nx = img.shape
    out = np.zeros_like(img)
    for i in range(ny):
        for j in range(nx):
            out[i, j] = bicubic_at(img, j + u[i, j], i + v[i, j], border_out)
    return out


# --- elap_recsep.c: Poisson/harmonic fill ---

def _getpixel_1(x, i, j):
    h, w = x.shape
    i = min(max(i, 0), w - 1)
    j = min(max(j, 0), h - 1)
    return x[j, i]


def _laplacian(x, i, j):
    return (
        -4 * _getpixel_1(x, i, j)
        + _getpixel_1(x, i + 1, j)
        + _getpixel_1(x, i, j + 1)
        + _getpixel_1(x, i - 1, j)
        + _getpixel_1(x, i, j - 1)
    )


def _harmonic_ext(x, timestep, niter, init):
    h, w = x.shape
    mask = [(i, j) for j in range(h) for i in range(w) if np.isnan(x[j, i])]
    y = np.where(np.isfinite(x), x, init)
    for _ in range(niter):
        maxup = 0.0
        for (i, j) in mask:
            new = y[j, i] + timestep * _laplacian(y, i, j)
            maxup = max(maxup, abs(y[j, i] - new))
            y[j, i] = new
        if maxup < 1e-10:
            break
    return y


def _zoom_out2(im):
    ih, iw = im.shape
    oh, ow = (ih + 1) // 2, (iw + 1) // 2
    out = np.zeros((oh, ow), dtype=im.dtype)
    for j in range(oh):
        for i in range(ow):
            a = [
                _getpixel_1(im, 2 * i, 2 * j),
                _getpixel_1(im, 2 * i + 1, 2 * j),
                _getpixel_1(im, 2 * i, 2 * j + 1),
                _getpixel_1(im, 2 * i + 1, 2 * j + 1),
            ]
            fin = [t for t in a if np.isfinite(t)]
            out[j, i] = sum(fin) / len(fin) if fin else np.nan
    return out


def _zoom_in2(im, oh, ow):
    out = np.zeros((oh, ow), dtype=im.dtype)
    for j in range(oh):
        for i in range(ow):
            # round((i-0.5)/2): C round() = half away from zero
            def rnd(t):
                return math.floor(t + 0.5) if t >= 0 else math.ceil(t - 0.5)
            out[j, i] = _getpixel_1(im, rnd((i - 0.5) / 2), rnd((j - 0.5) / 2))
    return out


def elap_recursive(im, timestep, niter, scale):
    h, w = im.shape
    if scale > 1:
        small = _zoom_out2(im)
        outs = elap_recursive(small, timestep, niter, scale - 1)
        init = _zoom_in2(outs, h, w)
    else:
        init = np.zeros_like(im)
    return _harmonic_ext(im, timestep, niter, init)

"""Batched Poisson/harmonic hole filling on fixed-size patch canvases.

Batched re-design of ``src/elap_recsep.c`` (used by ``interpolate_poisson``,
``local_faldoi.cpp:326-368``): coarse-to-fine multigrid where each level
fills NaN holes by a few relaxation sweeps of the Laplace equation, with the
coarse solution (2x zoom-out with NaN-discarding block averages) as init.

Everything is expressed as static shifts + ``where`` masks (no gathers), so
the whole pyramid vectorises cleanly on the VPU under ``vmap``.

Differences from the reference, by design (documented for parity review):

* the reference's ``perform_one_iteration`` is a raster-order Gauss-Seidel
  over the masked pixels; a sequential scan is hostile to vectorisation, so
  we use red-black Gauss-Seidel (two half-sweeps), which converges
  comparably.  The fill only *initialises* the patch PD solve, which then
  runs its own iterations, so the end-to-end effect is below the EPE gate.
* the reference's clamped-index block average (``zoom_out_by_factor_two``)
  equals a NaN-discarding mean over the in-box cells (clamping duplicates
  values uniformly), which is what we compute.
* all levels live on static (P, P) canvases with a dynamic valid box
  (ph, pw) so the whole pyramid is shape-static under ``vmap``/``jit``.

Reference call site: timestep 0.4, niter 3, scale 7 (local_faldoi.cpp:357).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


def _level_sizes(p: int, scale: int):
    sizes = [p]
    for _ in range(scale - 1):
        if sizes[-1] == 1:
            break  # 1x1 levels are exact no-ops (clamped laplacian = 0)
        sizes.append(max(1, math.ceil(sizes[-1] / 2)))
    return sizes


def _shift(y, dr, dc):
    """Static shift pulling the neighbour at (+dr, +dc) into each cell,
    repeating the canvas edge (box clamping is applied by callers)."""
    if dr == 1:
        y = jnp.concatenate([y[1:, :], y[-1:, :]], axis=0)
    elif dr == -1:
        y = jnp.concatenate([y[:1, :], y[:-1, :]], axis=0)
    if dc == 1:
        y = jnp.concatenate([y[:, 1:], y[:, -1:]], axis=1)
    elif dc == -1:
        y = jnp.concatenate([y[:, :1], y[:, :-1]], axis=1)
    return y


def _neighbors_clamped(y, ph, pw, p):
    """The four getpixel_1 neighbours with clamping at the valid box."""
    rows = jnp.arange(p)[:, None]
    cols = jnp.arange(p)[None, :]
    right = jnp.where(cols + 1 < pw, _shift(y, 0, 1), y)
    left = jnp.where(cols - 1 >= 0, _shift(y, 0, -1), y)
    down = jnp.where(rows + 1 < ph, _shift(y, 1, 0), y)
    up = jnp.where(rows - 1 >= 0, _shift(y, -1, 0), y)
    return right, left, down, up


def _relax(y, hole, ph, pw, timestep, niter, p, exact=True):
    """Gauss-Seidel relaxation of the holes on the valid box, reproducing
    ``perform_one_iteration`` (elap_recsep.c:49-68).

    ``exact=True``: EXACT raster-order GS.  Raster GS on the 5-point stencil
    decomposes exactly into anti-diagonal wavefronts: updating (r, c) reads
    already-updated (r-1, c) and (r, c-1) — both on diagonal r+c-1 — and
    not-yet-updated (r+1, c), (r, c+1) on diagonal r+c+1, so processing
    diagonals 0..2p-2 in order with all cells of a diagonal in parallel
    produces bit-identical values to the serial raster loop.  (The C code's
    early break at maxupdate < 1e-10 is a no-op difference: a converged
    hole's Laplacian is 0, so further sweeps don't move it.)  Cost: 2p-1
    sequential full-canvas steps per sweep.

    ``exact=False``: red-black GS — ~10x cheaper (2 half-sweeps instead of
    2p-1 diagonal steps) but its values differ from the reference by up to
    ~0.35.  That difference only matters where the fill value survives into
    the output: the CSAD-family local solvers (m4-m7) have an inert TV term
    (see core/functionals.py) and pass the init straight through, so they
    need ``exact=True``; the TVL1/NLTV families re-solve the patch and are
    parity-validated with red-black (r2: full-pipeline var EPE 0.0272).

    Env overrides for experiments: FALDOI_FILL_RB=1 forces red-black,
    FALDOI_FILL_EXACT=1 forces exact.
    """
    import os

    if os.environ.get("FALDOI_FILL_RB") == "1":
        exact = False
    elif os.environ.get("FALDOI_FILL_EXACT") == "1":
        exact = True

    rows = jnp.arange(p)[:, None]
    cols = jnp.arange(p)[None, :]
    inbox = (rows < ph) & (cols < pw)
    diag = rows + cols

    if not exact:
        red = diag % 2 == 0

        def halfsweep(y, color_mask):
            r, l, d, u = _neighbors_clamped(y, ph, pw, p)
            lap = -4.0 * y + r + l + d + u
            return jnp.where(hole & inbox & color_mask, y + timestep * lap, y)

        for _ in range(niter):
            y = halfsweep(y, red)
            y = halfsweep(y, ~red)
        return y

    upd = hole & inbox

    def sweep(y):
        def one_diag(d, y):
            r, l, dn, up = _neighbors_clamped(y, ph, pw, p)
            lap = -4.0 * y + r + l + dn + up
            return jnp.where(upd & (diag == d), y + timestep * lap, y)

        return jax.lax.fori_loop(0, 2 * p - 1, one_diag, y)

    for _ in range(niter):
        y = sweep(y)
    return y


def _zoom_out2(x, ph, pw, p_parent, p_child):
    """NaN-discarding 2x2 block average (elap_recsep.c:129-185)."""
    rows = jnp.arange(p_parent)[:, None]
    cols = jnp.arange(p_parent)[None, :]
    x = jnp.where((rows < ph) & (cols < pw), x, jnp.nan)
    pad = 2 * p_child - p_parent
    if pad:
        x = jnp.pad(x, ((0, pad), (0, pad)), constant_values=jnp.nan)
    blocks = jnp.stack(
        [x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]]
    )
    fin = jnp.isfinite(blocks)
    cnt = fin.sum(axis=0)
    s = jnp.where(fin, blocks, 0.0).sum(axis=0)
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)


def _zoom_in2(x, p_parent):
    """Pixel replication into 2x2 blocks; the reference's
    round((i-0.5)/2) index reduces to i//2 (elap_recsep.c:191-199)."""
    up = jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1)
    return up[:p_parent, :p_parent]


def poisson_fill_canvas(
    x: jnp.ndarray,
    ph,
    pw,
    timestep: float = 0.4,
    niter: int = 3,
    scale: int = 7,
    exact: bool = True,
) -> jnp.ndarray:
    """Fill NaNs of a (P, P) canvas whose valid region is [0, ph) x [0, pw).

    Values outside the valid box are ignored and returned as 0.
    ``exact``: raster-order GS (reference-exact) vs red-black (see _relax).
    """
    p = x.shape[0]
    sizes = _level_sizes(p, scale)

    levels = [x]
    phs = [ph]
    pws = [pw]
    for k in range(1, len(sizes)):
        levels.append(
            _zoom_out2(levels[-1], phs[-1], pws[-1], sizes[k - 1], sizes[k])
        )
        phs.append((phs[-1] + 1) // 2)
        pws.append((pws[-1] + 1) // 2)

    out = None
    for k in range(len(sizes) - 1, -1, -1):
        xk = levels[k]
        init = jnp.zeros_like(xk) if out is None else _zoom_in2(out, sizes[k])
        rows = jnp.arange(sizes[k])[:, None]
        cols = jnp.arange(sizes[k])[None, :]
        inbox = (rows < phs[k]) & (cols < pws[k])
        hole = ~jnp.isfinite(xk)
        y = jnp.where(inbox, jnp.where(hole, init, xk), 0.0)
        y = jnp.where(jnp.isfinite(y), y, 0.0)
        out = _relax(y, hole, phs[k], pws[k], timestep, niter, sizes[k],
                     exact=exact)
    return out


@functools.partial(jax.jit,
                   static_argnames=("timestep", "niter", "scale", "exact"))
def poisson_fill_batch(
    x: jnp.ndarray, ph: jnp.ndarray, pw: jnp.ndarray,
    timestep: float = 0.4, niter: int = 3, scale: int = 7,
    exact: bool = True,
) -> jnp.ndarray:
    """vmap of poisson_fill_canvas over a (B, P, P) batch with (B,) boxes."""
    return jax.vmap(
        lambda xi, phi, pwi: poisson_fill_canvas(xi, phi, pwi, timestep,
                                                 niter, scale, exact)
    )(x, ph, pw)


def _rect_level_sizes(py: int, px: int, scale: int):
    sizes = [(py, px)]
    for _ in range(scale - 1):
        if max(sizes[-1]) == 1:
            break
        sizes.append((max(1, math.ceil(sizes[-1][0] / 2)),
                      max(1, math.ceil(sizes[-1][1] / 2))))
    return sizes


def _rect_zoom_out2(x, child):
    """NaN-discarding 2x2 block average onto a (cy, cx) canvas."""
    cy, cx = child
    pad_y = 2 * cy - x.shape[0]
    pad_x = 2 * cx - x.shape[1]
    if pad_y or pad_x:
        x = jnp.pad(x, ((0, pad_y), (0, pad_x)), constant_values=jnp.nan)
    blocks = jnp.stack(
        [x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]]
    )
    fin = jnp.isfinite(blocks)
    cnt = fin.sum(axis=0)
    s = jnp.where(fin, blocks, 0.0).sum(axis=0)
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), jnp.nan)


def _rect_relax(y, hole, timestep, niter):
    """Red-black Gauss-Seidel on a full rectangular canvas (Neumann edges)."""
    py, px = y.shape
    rows = jnp.arange(py)[:, None]
    cols = jnp.arange(px)[None, :]
    red = (rows + cols) % 2 == 0

    def nb(a):
        right = jnp.where(cols + 1 < px, _shift(a, 0, 1), a)
        left = jnp.where(cols - 1 >= 0, _shift(a, 0, -1), a)
        down = jnp.where(rows + 1 < py, _shift(a, 1, 0), a)
        up = jnp.where(rows - 1 >= 0, _shift(a, -1, 0), a)
        return right, left, down, up

    def halfsweep(y, color):
        r, l, d, u = nb(y)
        lap = -4.0 * y + r + l + d + u
        return jnp.where(hole & color, y + timestep * lap, y)

    for _ in range(niter):
        y = halfsweep(y, red)
        y = halfsweep(y, ~red)
    return y


def poisson_fill_image(
    x: jnp.ndarray, timestep: float = 0.4, niter: int = 3,
    scale: int = 0,
) -> jnp.ndarray:
    """Whole-image NaN fill with the SAME coarse-to-fine multigrid the
    reference applies per patch (``elap_recursive_separable``,
    elap_recsep.c:225; timestep 0.4, 3 relaxation sweeps per level) — run
    once globally so every sweep's thousands of patch inits share one fill.
    ``scale=0`` = as many levels as needed to reach 1x1 (full long-range
    propagation; an isolated seed reaches the whole image).
    """
    h, w = x.shape
    if not scale:
        scale = max(h, w).bit_length() + 1
    sizes = _rect_level_sizes(h, w, scale)
    levels = [x]
    for k in range(1, len(sizes)):
        levels.append(_rect_zoom_out2(levels[-1], sizes[k]))
    out = None
    for k in range(len(sizes) - 1, -1, -1):
        xk = levels[k]
        if out is None:
            init = jnp.zeros_like(xk)
        else:
            up = jnp.repeat(jnp.repeat(out, 2, axis=0), 2, axis=1)
            init = up[: sizes[k][0], : sizes[k][1]]
        hole = ~jnp.isfinite(xk)
        y = jnp.where(hole, init, xk)
        y = jnp.where(jnp.isfinite(y), y, 0.0)
        out = _rect_relax(y, hole, timestep, niter)
    return out


def _shift_stack(a, dy, dx):
    """Edge-replicated shift of a (C, h, w) stack by (+dy, +dx)."""
    c, h, w = a.shape
    pad = ((0, 0), (max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0)))
    ap = jnp.pad(a, pad, mode="edge")
    return ap[:, max(-dy, 0): max(-dy, 0) + h, max(-dx, 0): max(-dx, 0) + w]


def nearest_fill_image(
    x: jnp.ndarray, smooth_iters: int = 6, timestep: float = 0.4,
) -> jnp.ndarray:
    """Whole-image NaN fill by NEAREST-seed extension (jump-flooding) plus a
    few pinned relaxation sweeps.

    Why not one global harmonic fill: the reference's per-patch
    ``interpolate_poisson`` sees ONLY the fixed pixels inside the patch, so
    ahead of a growth front the init is an *extension of that front's flow*.
    A global harmonic fill instead interpolates *between* distant fronts
    across unfixed terrain, biasing every frontier patch's init toward the
    opposing front — the batched sweeps then converge to visibly different
    flow than the serial reference in seed-sparse regions.  Nearest-seed
    extension restores the patch-local character (each cell continues its
    closest front) while still covering the whole image; the relaxation
    sweeps smooth the Voronoi seams the way the patch fill smooths its
    boundary values.
    """
    h, w = x.shape
    fin = jnp.isfinite(x)
    yy = jnp.broadcast_to(jnp.arange(h, dtype=x.dtype)[:, None], (h, w))
    xx = jnp.broadcast_to(jnp.arange(w, dtype=x.dtype)[None, :], (h, w))
    far = jnp.asarray(-1.0e6, x.dtype)
    state = jnp.stack([
        jnp.where(fin, yy, far),
        jnp.where(fin, xx, far),
        jnp.where(fin, x, 0.0),
    ])
    best = jnp.where(fin, 0.0, jnp.inf)

    k = 1
    while k * 2 < max(h, w):
        k *= 2
    strides = []
    while k >= 1:
        strides.append(k)
        k //= 2

    for k in strides:
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                nb = _shift_stack(state, dy, dx)
                d2 = (yy - nb[0]) ** 2 + (xx - nb[1]) ** 2
                better = d2 < best
                best = jnp.where(better, d2, best)
                state = jnp.where(better[None], nb, state)

    y = jnp.where(fin, x, state[2])
    return _rect_relax(y, ~fin, timestep, smooth_iters)

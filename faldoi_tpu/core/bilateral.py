"""Bilateral flow filtering — the reference's (dormant) bilateral machinery.

Reference: ``init_weights_bilateral`` precomputes, for every pixel, a 5x5
(PATCH_BILATERAL_FILTER=2) neighborhood of weights
``exp(-0.5*d2/SIGMA_DIST^2) * exp(-0.5*(|I0(p)-I0(q)|/SIGMA_COLOR)^2)``
(energy_model.cpp:97-157); ``bilateral_filter`` then runs
ITER_BILATERAL_FILTER=10 weighted-average iterations of the flow at
non-trusted, non-fixed pixels, seeding non-trusted flow with 0
(local_faldoi.cpp:380-482).  The call site is disabled in the reference's
hot path (local_faldoi.cpp:701-702), so this is a capability, not a default.

Dense formulation: no per-pixel weight tables — the 5x5 neighborhood
becomes 25 static shifts of the image plane, weights computed on the fly
(they are one multiply+exp per shift, cheaper than materialising a
(h, w, 25) table in HBM), iterated as dense Jacobi updates.

Documented deviations from the C code (see PARITY.md "known deviations"):
- raster-order (Gauss-Seidel) updates become whole-image Jacobi sweeps;
- the reference's ``u1_filter[i] = new_flow_u1`` writes to a patch-local
  index instead of the image index (an out-of-path bug) — not reproduced;
- applied image-wide at all untrusted pixels rather than per-patch (the
  patch loop unioned to the same set).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from faldoi_tpu.params import (
    ITER_BILATERAL_FILTER,
    PATCH_BILATERAL_FILTER,
    SIGMA_BILATERAL_COLOR,
    SIGMA_BILATERAL_DIST,
)


def _shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """a[y+dy, x+dx] with zero padding outside (masked separately)."""
    h, w = a.shape[-2:]
    pad = [(0, 0)] * (a.ndim - 2) + [
        (max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))
    ]
    ap = jnp.pad(a, pad)
    sl = [slice(None)] * (a.ndim - 2) + [
        slice(max(-dy, 0), max(-dy, 0) + h), slice(max(dx, 0), max(dx, 0) + w)
    ]
    return ap[tuple(sl)]


def _inside(h: int, w: int, dy: int, dx: int) -> jnp.ndarray:
    """1 where (y+dy, x+dx) is inside the image — the reference's clamped
    neighborhood box (get_index_patch) simply excludes those positions."""
    yy = jnp.arange(h)[:, None] + dy
    xx = jnp.arange(w)[None, :] + dx
    return (((yy >= 0) & (yy < h)) & ((xx >= 0) & (xx < w))).astype(jnp.float32)


@jax.jit
def bilateral_filter_flow(i0n, u1, u2, trust, fixed,
                          iters: int = ITER_BILATERAL_FILTER):
    """Fill/smooth (u1, u2) at pixels with trust==0 and fixed==0 by
    bilateral weighted averaging of the surrounding flow.

    i0n: (h, w) normalized grayscale frame (weights source, like the
    reference's ``i0`` passed to init_weights_bilateral).
    trust, fixed: (h, w) int/bool masks.  Returns filtered (u1, u2).
    """
    h, w = i0n.shape
    keep = (trust.astype(bool) | fixed.astype(bool))
    r = PATCH_BILATERAL_FILTER

    # seeded exactly like the reference: trusted flow kept, rest 0
    f1 = jnp.where(keep, u1, 0.0)
    f2 = jnp.where(keep, u2, 0.0)

    shifts = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    wsp = {
        s: jnp.float32(
            jnp.exp(-0.5 * (s[0] ** 2 + s[1] ** 2) / SIGMA_BILATERAL_DIST ** 2)
        )
        for s in shifts
    }
    wcol = {
        s: jnp.exp(
            -0.5 * ((i0n - _shift(i0n, *s)) / SIGMA_BILATERAL_COLOR) ** 2
        ) * _inside(h, w, *s)
        for s in shifts
    }

    def body(_, carry):
        f1, f2 = carry
        num1 = jnp.zeros_like(f1)
        num2 = jnp.zeros_like(f2)
        den = jnp.zeros_like(f1)
        for s in shifts:
            wgt = wsp[s] * wcol[s]
            num1 = num1 + wgt * _shift(f1, *s)
            num2 = num2 + wgt * _shift(f2, *s)
            den = den + wgt
        den = jnp.maximum(den, 1e-12)
        f1n = jnp.where(keep, f1, num1 / den)
        f2n = jnp.where(keep, f2, num2 / den)
        return (f1n, f2n)

    f1, f2 = jax.lax.fori_loop(0, iters, body, (f1, f2))
    u1 = jnp.where(keep, u1, f1)
    u2 = jnp.where(keep, u2, f2)
    return u1, u2

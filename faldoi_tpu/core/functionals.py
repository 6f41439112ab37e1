"""Canvas patch solvers for all nine functionals (methods 0-8).

The reference implements the per-patch primal-dual scheme nine times
(tvl2_model.cpp, tvl2w_model.cpp, nltv_model.cpp, nltvw_model.cpp,
tvcsad_model.cpp, tvcsadw_model.cpp, nltvcsad_model.cpp,
nltvcsadw_model.cpp, tvl2_model_occ.cpp).  Here each functional is one
canvas solver built from shared pieces:

* data-term prox: TV-L1 threshold (optionally Gaussian-window weighted) or
  the CSAD median-of-breakpoints (optionally weighted);
* regulariser: TV dual (joint 4-norm for TVL1, per-component for CSAD) or
  the 24-neighbour NLTV dual with Lab support weights.

All solvers share the signature
    solver(sc, ci, cj, oy, ox, ph, pw, u1, u2) -> (u1, u2, ener)
where ``sc`` is a pytree of per-growing constants built by
``make_solver_consts`` and (ci, cj) is the patch centre.  They run on
(P, P) canvases with a dynamic valid box and are vmapped by the sweep.

Reference-semantics notes:
* local NLTV normalises the dual gradient by the *patch-restricted* weight
  sum (recomputed per solve, nltv_model.cpp:355-380 region) and its patch
  non-local divergence is NOT normalised (aux_energy_model.cpp:178-212);
* local CSAD restricts the 7x7 neighbourhood to the patch box and uses
  grad = hypot(|gradI1w|^2, 0.01) (tvcsad_model.cpp:361 region), keeping
  the reference's off-by-one median index it/2+1;
* the NLTV dual state is cold-started per solve (the reference warm-starts
  from a shared image-wide buffer mutated by previous solves — a
  sequential side effect a parallel batch cannot reproduce).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from faldoi_tpu.ops.bicubic import bicubic_interp_at
from faldoi_tpu.core.patch_solver import crop_padded
from faldoi_tpu.ops.stencils import divergence_patch, forward_gradient_patch
from faldoi_tpu.ops.nonlocal_ops import neighbor_offsets
from faldoi_tpu.core.pd_common import tvl2_getD, tvl2_getP
from faldoi_tpu.params import DT_R, GRAD_IS_ZERO, NL_BETA
from faldoi_tpu import params as P

class SolverConsts(NamedTuple):
    """Per-growing constants shared by the canvas solvers."""

    i0pad: jnp.ndarray           # edge-padded source frame
    i1: jnp.ndarray              # full target frame
    i1x: jnp.ndarray
    i1y: jnp.ndarray
    i1_stack: jnp.ndarray        # (h, w, 3) channels-last (i1, i1x, i1y):
                                 # one gather warps all three (ops.bicubic)
    lambda_: jnp.ndarray         # scalars (traced)
    theta: jnp.ndarray
    tau: jnp.ndarray
    tol: jnp.ndarray
    w1d: Optional[jnp.ndarray] = None      # (2wr+1,) window (weighted methods)
    wp_pad: Optional[jnp.ndarray] = None   # (24, h+p, w+p) NLTV weights
    # occlusion extras
    i_1: Optional[jnp.ndarray] = None
    i_1x: Optional[jnp.ndarray] = None
    i_1y: Optional[jnp.ndarray] = None
    gpad: Optional[jnp.ndarray] = None
    occ_prm: Optional[jnp.ndarray] = None  # (alpha,beta,mu,tau_u,tau_eta,tau_chi)


def make_solver_consts(method, i0pad, i1, i1x, i1y, lam, theta, tau, tol,
                       wr=P.PAR_DEFAULT_WINSIZE, i0_planes=None, p=None):
    """Build SolverConsts for a growing direction."""
    kw = dict(
        i0pad=i0pad, i1=i1, i1x=i1x, i1y=i1y,
        i1_stack=jnp.stack([i1, i1x, i1y], axis=-1),
        lambda_=jnp.float32(lam), theta=jnp.float32(theta),
        tau=jnp.float32(tau), tol=jnp.float32(tol),
    )
    if method in (P.M_TVL1_W, P.M_NLTVL1_W, P.M_TVCSAD_W, P.M_NLTVCSAD_W):
        from faldoi_tpu.ops.gaussian import gaussian1d_weight

        kw["w1d"] = jnp.asarray(gaussian1d_weight(wr))
    if method in (P.M_NLTVL1, P.M_NLTVL1_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W):
        from faldoi_tpu.ops.nonlocal_ops import nltv_weights, rgb_to_lab_np

        assert i0_planes is not None, "NLTV needs the source color planes"
        lab = rgb_to_lab_np(np.asarray(i0_planes))
        # local step scales: NL_BETA=2 spatial, NL_INTENSITY=2 color
        wp, _, _ = nltv_weights(lab, NL_BETA, float(P.NL_BETA),
                                float(P.NL_INTENSITY))
        pp = p if p is not None else 2 * wr + 1
        kw["wp_pad"] = jnp.pad(jnp.asarray(wp), ((0, 0), (0, pp), (0, pp)))
    return SolverConsts(**kw)


def _bounded_pd_loop(cond, body, st, max_iters, unroll_limit=8):
    """Run the tol-gated PD iteration either as a ``lax.while_loop`` or — for
    the local step's tiny caps (max_iter_patch=4) — as a STATIC masked
    unroll: each step computes body(st) and keeps the old state where
    ``cond`` already failed.  Values are identical to the (vmapped)
    while_loop (frozen lanes keep their state either way), but the unrolled
    form has no control-flow barrier, so XLA can fuse the whole solve into
    a few kernels instead of round-tripping the carry through device
    memory every iteration.
    """
    if max_iters > unroll_limit:
        return jax.lax.while_loop(cond, body, st)
    for _ in range(max_iters):
        new = jax.tree.map(lambda a: jnp.asarray(a), body(st))
        keep = jnp.logical_not(cond(st))
        st = jax.tree.map(
            lambda old, nw: jnp.where(keep, old, nw), st, new)
    return st


def _canvas_setup(p, oy, ox, ph, pw, dtype):
    rows = jnp.arange(p)[:, None]
    cols = jnp.arange(p)[None, :]
    inbox = (rows < ph) & (cols < pw)
    gx = (ox + cols).astype(dtype)
    gy = (oy + rows).astype(dtype)
    return rows, cols, inbox, gx, gy


def _warp3(sc: SolverConsts, gx, gy, u1, u2, inbox):
    """Warp (i1, i1x, i1y) at the patch cells' displaced positions: one
    4x4x3 window gather per cell (ops.bicubic)."""
    su = jnp.where(inbox, u1, 0.0)
    sv = jnp.where(inbox, u2, 0.0)
    w = bicubic_interp_at(sc.i1_stack, gx + su, gy + sv, False)
    return w[..., 0], w[..., 1], w[..., 2]


def _warp1(sc: SolverConsts, gx, gy, u1, u2, inbox):
    """Warp only i1 (the energy eval needs no derivatives)."""
    su = jnp.where(inbox, u1, 0.0)
    sv = jnp.where(inbox, u2, 0.0)
    return bicubic_interp_at(sc.i1, gx + su, gy + sv, False)


def _crop_i0(sc: SolverConsts, oy, ox, p):
    """Source-frame patch crop."""
    return crop_padded(sc.i0pad, oy, ox, p)


def _weight2d(w1d, rows, cols, oy, ox, cj, ci, wr):
    """Gaussian-window weight (tvl2w_model.cpp:227): W = w1d[row - cj + wr] *
    w1d[col - ci + wr] in global coordinates (handles clamped boxes)."""
    ridx = jnp.clip(oy + rows - cj + wr, 0, 2 * wr)
    cidx = jnp.clip(ox + cols - ci + wr, 0, 2 * wr)
    return w1d[ridx] * w1d[cidx]


def _tvl1_threshold_w(u1, u2, rho_c, i1wx, i1wy, grad, l_t_w):
    """3-way threshold with a spatially-varying l_t (tvl2w_model.cpp:374+)."""
    rho = rho_c + i1wx * u1 + i1wy * u2
    fi = jnp.where(grad < GRAD_IS_ZERO, 0.0, -rho / jnp.where(grad == 0, 1.0, grad))
    lo = rho < -l_t_w * grad
    hi = rho > l_t_w * grad
    d1 = jnp.where(lo, l_t_w * i1wx, jnp.where(hi, -l_t_w * i1wx, fi * i1wx))
    d2 = jnp.where(lo, l_t_w * i1wy, jnp.where(hi, -l_t_w * i1wy, fi * i1wy))
    return u1 + d1, u2 + d2


# ---------------------------------------------------------------------------
# TV-L1 (+ weighted)
# ---------------------------------------------------------------------------


def _solve_tvl1_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                       p, warps, max_iters, wr, weighted):
    # measurement-only ablations (see local_step._sweep_body)
    _ablate = os.environ.get("FALDOI_ABLATE", "")

    rows, cols, inbox, gx, gy = _canvas_setup(p, oy, ox, ph, pw, u1.dtype)
    i0_patch = _crop_i0(sc, oy, ox, p)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, wr)
        l_t_eff = l_t * w2d
    else:
        w2d = 1.0
        l_t_eff = l_t

    xi = tuple(jnp.zeros_like(u1) for _ in range(4))
    v1, v2 = u1, u2

    for _ in range(warps):
        if "nowarp" in _ablate:
            i1w, i1wx, i1wy = u1 * 0.1, u1 * 0.01, u2 * 0.01
        else:
            i1w, i1wx, i1wy = _warp3(sc, gx, gy, u1, u2, inbox)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0_patch

        def body(st):
            u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, v1, v2, err, n = st
            v1, v2 = _tvl1_threshold_w(u1, u2, rho_c, i1wx, i1wy, grad, l_t_eff)
            u1x, u1y = forward_gradient_patch(u1_, ph, pw)
            u2x, u2y = forward_gradient_patch(u2_, ph, pw)
            xi11, xi12, xi21, xi22 = tvl2_getD(
                xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, sc.tau
            )
            d1 = divergence_patch(xi11, xi12, ph, pw)
            d2 = divergence_patch(xi21, xi22, ph, pw)
            nu1, nu2, u_n = tvl2_getP(u1, u2, v1, v2, d1, d2, sc.theta, sc.tau)
            err = jnp.max(jnp.where(inbox, u_n, 0.0))
            return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2,
                    xi11, xi12, xi21, xi22, v1, v2, err, n + 1)

        def cond(st):
            return jnp.logical_and(st[10] > sc.tol * sc.tol, st[11] < max_iters)

        st = (u1, u2, u1, u2, *xi, v1, v2,
              jnp.asarray(jnp.inf, u1.dtype), jnp.asarray(0, jnp.int32))
        if "nopd" not in _ablate:
            st = _bounded_pd_loop(cond, body, st, max_iters)
        u1, u2 = st[0], st[1]
        xi = st[4:8]
        v1, v2 = st[8], st[9]

    # eval (tvl2_model.cpp:174-243 / tvl2w_model.cpp:227)
    u1 = jnp.where(inbox, u1, 0.0)
    u2 = jnp.where(inbox, u2, 0.0)
    v1 = jnp.where(inbox, v1, 0.0)
    v2 = jnp.where(inbox, v2, 0.0)
    u1x, u1y = forward_gradient_patch(u1, ph, pw)
    u2x, u2y = forward_gradient_patch(u2, ph, pw)
    if "noeval" in _ablate:
        i1w = u1 * 0.1
    else:
        i1w = _warp1(sc, gx, gy, u1, u2, inbox)
    dt = sc.lambda_ * jnp.abs(i1w - i0_patch) * (w2d if weighted else 1.0)
    dc = (1.0 / (2.0 * sc.theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    g = jnp.sqrt(u1x * u1x + u1y * u1y + u2x * u2x + u2y * u2y)
    ener = jnp.sum(jnp.where(inbox, dc + dt + g, 0.0)) / (ph * pw)
    return u1, u2, chi, ener


# ---------------------------------------------------------------------------
# NLTV regulariser pieces (canvas domain, patch-restricted)
# ---------------------------------------------------------------------------

NLTV_OFFS = tuple(neighbor_offsets(NL_BETA))


def _nltv_crop_weights(sc: SolverConsts, oy, ox, p, rows, cols, ph, pw):
    """Crop the (24, h+p, w+p) weight planes and mask neighbours that leave
    the patch box (validate_ap_patch semantics).  Returns (wp, wt)."""
    wp_full = jax.lax.dynamic_slice(
        sc.wp_pad, (0, oy, ox), (len(NLTV_OFFS), p, p)
    )
    inbox = (rows < ph) & (cols < pw)
    masks = []
    for (dy, dx) in NLTV_OFFS:
        nb_r = rows + dy
        nb_c = cols + dx
        masks.append(
            inbox & (nb_r >= 0) & (nb_r < ph) & (nb_c >= 0) & (nb_c < pw)
        )
    mask = jnp.stack(masks)
    wp = jnp.where(mask, wp_full, 0.0)
    wt = jnp.maximum(wp.sum(axis=0), 1e-30)
    return wp, wt


def _shift_canvas(x, dy, dx):
    """out[r,c] = x[r+dy, c+dx], zero outside (masks handle validity)."""
    pr, pc = x.shape[-2:]
    pad = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    xp = jnp.pad(x, pad)
    return xp[max(dy, 0) : max(dy, 0) + pr, max(dx, 0) : max(dx, 0) + pc]


def _nltv_getD(sc_p, u, wp, wt, tau):
    """nltvl1_getD (nltv_model.cpp:211-273): per-neighbour dual update with
    the patch-restricted wt."""
    new = []
    for j, (dy, dx) in enumerate(NLTV_OFFS):
        u_n = _shift_canvas(u, dy, dx)
        nlgr = wp[j] * (u - u_n) / wt
        upd = (sc_p[j] + tau * nlgr) / (1.0 + tau * jnp.abs(nlgr))
        new.append(jnp.where(wp[j] > 0, upd, sc_p[j]))
    return jnp.stack(new)


def _nltv_div(sc_p, wp):
    """Patch non-local divergence — UNNORMALISED (aux_energy_model.cpp:178)."""
    n_d = len(NLTV_OFFS)
    div = jnp.zeros_like(wp[0])
    for j, (dy, dx) in enumerate(NLTV_OFFS):
        pyx = _shift_canvas(sc_p[n_d - 1 - j], dy, dx)
        div = div + wp[j] * (sc_p[j] - pyx)
    return div


# ---------------------------------------------------------------------------
# CSAD data-term pieces (canvas domain, patch-restricted 7x7)
# ---------------------------------------------------------------------------

CSAD_OFFS = tuple(neighbor_offsets(DT_R))


def _csad_masks(rows, cols, ph, pw):
    masks = []
    for (dy, dx) in CSAD_OFFS:
        nb_r = rows + dy
        nb_c = cols + dx
        masks.append((nb_r >= 0) & (nb_r < ph) & (nb_c >= 0) & (nb_c < pw))
    return jnp.stack(masks)


def _csad_b(i0_patch, i1w, i1wx, i1wy, u1, u2, grad, masks):
    """b_j = (I0 - I0_j - I1w + I1w_j + I1wx u1 + I1wy u2)/grad
    (tvcsad_model.cpp:374+)."""
    base = i0_patch - i1w + i1wx * u1 + i1wy * u2
    bs = []
    for j, (dy, dx) in enumerate(CSAD_OFFS):
        i0n = _shift_canvas(i0_patch, dy, dx)
        i1wn = _shift_canvas(i1w, dy, dx)
        bs.append(jnp.where(masks[j], (base - i0n + i1wn) / grad, 0.0))
    return jnp.stack(bs)


def _csad_vstep(u1, u2, b, i1wx, i1wy, grad, masks, ncount, l_t_eff):
    """Median-of-breakpoints prox with the reference's it/2+1 index."""
    n_d = b.shape[0]
    dot = (i1wx * u1 + i1wy * u2) / grad
    part1 = jnp.where(masks, -(b - dot[None]), jnp.inf)
    jidx = jnp.arange(n_d + 1, dtype=jnp.float32)[:, None, None]
    part2 = jnp.where(
        jidx <= ncount[None],
        (ncount[None] - 2.0 * jidx) * (l_t_eff * grad)[None],
        jnp.inf,
    )
    ba = jnp.sort(jnp.concatenate([part1, part2], axis=0), axis=0)
    sel = (ncount + 1.0).astype(jnp.int32)[None]
    med = jnp.take_along_axis(ba, sel, axis=0)[0]
    return u1 - i1wx * med / grad, u2 - i1wy * med / grad


# ---------------------------------------------------------------------------
# NLTV-L1 (+ weighted)
# ---------------------------------------------------------------------------


def _solve_nltv_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                       p, warps, max_iters, wr, weighted):
    rows, cols, inbox, gx, gy = _canvas_setup(p, oy, ox, ph, pw, u1.dtype)
    i0_patch = _crop_i0(sc, oy, ox, p)
    wp, wt = _nltv_crop_weights(sc, oy, ox, p, rows, cols, ph, pw)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, wr)
        l_t_eff = l_t * w2d
    else:
        w2d = 1.0
        l_t_eff = l_t

    sc_p = jnp.zeros((len(NLTV_OFFS), p, p), u1.dtype)
    sc_q = jnp.zeros_like(sc_p)
    v1, v2 = u1, u2
    npx = jnp.asarray(ph * pw, u1.dtype)

    for _ in range(warps):
        i1w, i1wx, i1wy = _warp3(sc, gx, gy, u1, u2, inbox)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0_patch

        def body(st):
            u1, u2, u1_, u2_, sc_p, sc_q, v1, v2, err, n = st
            v1, v2 = _tvl1_threshold_w(u1, u2, rho_c, i1wx, i1wy, grad, l_t_eff)
            sc_p = _nltv_getD(sc_p, u1_, wp, wt, sc.tau)
            sc_q = _nltv_getD(sc_q, u2_, wp, wt, sc.tau)
            div_p = _nltv_div(sc_p, wp)
            div_q = _nltv_div(sc_q, wp)
            nu1 = u1 - sc.tau * (div_p + (u1 - v1) / sc.theta)
            nu2 = u2 - sc.tau * (div_q + (u2 - v2) / sc.theta)
            err = jnp.sum(
                jnp.where(inbox, (nu1 - u1) ** 2 + (nu2 - u2) ** 2, 0.0)
            ) / npx
            return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2, sc_p, sc_q,
                    v1, v2, err, n + 1)

        def cond(st):
            return jnp.logical_and(st[8] > sc.tol * sc.tol, st[9] < max_iters)

        st = (u1, u2, u1, u2, sc_p, sc_q, v1, v2,
              jnp.asarray(jnp.inf, u1.dtype), jnp.asarray(0, jnp.int32))
        st = _bounded_pd_loop(cond, body, st, max_iters)
        u1, u2, _, _, sc_p, sc_q, v1, v2 = st[:8]

    # eval (nltv_model.cpp:69-156); out-of-box canvas cells can hold
    # inf/junk — zero them before the shift-based regulariser (0*inf=NaN)
    u1 = jnp.where(inbox, u1, 0.0)
    u2 = jnp.where(inbox, u2, 0.0)
    v1 = jnp.where(inbox, v1, 0.0)
    v2 = jnp.where(inbox, v2, 0.0)
    i1w = _warp1(sc, gx, gy, u1, u2, inbox)
    dt = sc.lambda_ * jnp.abs(i1w - i0_patch) * (w2d if weighted else 1.0)
    dc = (1.0 / (2.0 * sc.theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    g = jnp.zeros_like(u1)
    for j, (dy, dx) in enumerate(NLTV_OFFS):
        u1n = _shift_canvas(u1, dy, dx)
        u2n = _shift_canvas(u2, dy, dx)
        g = g + wp[j] * (jnp.abs(u1 - u1n) + jnp.abs(u2 - u2n))
    g = g / wt
    ener = jnp.sum(jnp.where(inbox, dc + dt + g, 0.0)) / (ph * pw)
    return u1, u2, chi, ener


# ---------------------------------------------------------------------------
# TV-CSAD and NLTV-CSAD (+ weighted)
# ---------------------------------------------------------------------------


def _solve_csad_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                       p, warps, max_iters, wr, weighted, nltv_reg):
    # Reference quirk (methods 4/5): guided_tvcsad[_w] feeds tvcsad_getD the
    # flow-gradient buffers u1x/u1y/u2x/u2y which are NEVER written anywhere
    # (allocated by initialize_auxiliar_stuff, tvcsad_model.cpp:38-41, and
    # only ever READ at :255 and :135) — in practice zero pages, so the TV
    # duals stay 0, div_xi == 0, and eval's sqrt(g) term is 0.  The local
    # TV-CSAD solver is effectively data-prox-only; we reproduce that (it
    # defines the binaries' output, like the it/2+1 median index).  Set
    # FALDOI_CSAD_TRUE_TV=1 for the mathematically-intended solver.
    inert_tv = (not nltv_reg) and os.environ.get(
        "FALDOI_CSAD_TRUE_TV", "0") != "1"

    rows, cols, inbox, gx, gy = _canvas_setup(p, oy, ox, ph, pw, u1.dtype)
    i0_patch = _crop_i0(sc, oy, ox, p)
    masks = _csad_masks(rows, cols, ph, pw) & inbox[None]
    ncount = masks.sum(axis=0).astype(u1.dtype)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, wr)
        l_t_eff = l_t * w2d
    else:
        w2d = 1.0
        l_t_eff = l_t * jnp.ones_like(u1)

    if nltv_reg:
        wp, wt = _nltv_crop_weights(sc, oy, ox, p, rows, cols, ph, pw)
        sc_p = jnp.zeros((len(NLTV_OFFS), p, p), u1.dtype)
        sc_q = jnp.zeros_like(sc_p)
        reg_state = (sc_p, sc_q)
    else:
        reg_state = tuple(jnp.zeros_like(u1) for _ in range(4))
    v1, v2 = u1, u2
    npx = jnp.asarray(ph * pw, u1.dtype)

    for _ in range(warps):
        i1w, i1wx, i1wy = _warp3(sc, gx, gy, u1, u2, inbox)
        grad = jnp.hypot(i1wx * i1wx + i1wy * i1wy, 0.01)  # tvcsad_model.cpp:361
        b = _csad_b(i0_patch, i1w, i1wx, i1wy, u1, u2, grad, masks)

        def body(st):
            u1, u2, u1_, u2_, reg, v1, v2, err, n = st
            v1, v2 = _csad_vstep(u1, u2, b, i1wx, i1wy, grad, masks, ncount,
                                 l_t_eff)
            if nltv_reg:
                sc_p, sc_q = reg
                sc_p = _nltv_getD(sc_p, u1_, wp, wt, sc.tau)
                sc_q = _nltv_getD(sc_q, u2_, wp, wt, sc.tau)
                d1 = _nltv_div(sc_p, wp)
                d2 = _nltv_div(sc_q, wp)
                nu1 = u1 - sc.tau * (d1 + (u1 - v1) / sc.theta)
                nu2 = u2 - sc.tau * (d2 + (u2 - v2) / sc.theta)
                reg = (sc_p, sc_q)
            elif inert_tv:
                # duals pinned at 0 (reference zero-buffer quirk, see above)
                nu1 = u1 - sc.tau * ((u1 - v1) / sc.theta)
                nu2 = u2 - sc.tau * ((u2 - v2) / sc.theta)
            else:
                xi11, xi12, xi21, xi22 = reg
                u1x, u1y = forward_gradient_patch(u1_, ph, pw)
                u2x, u2y = forward_gradient_patch(u2_, ph, pw)
                # per-component projection (tvcsad_model.cpp:231-260)
                n1 = jnp.maximum(1.0, jnp.hypot(xi11, xi12))
                n2 = jnp.maximum(1.0, jnp.hypot(xi21, xi22))
                xi11 = (xi11 + sc.tau * u1x) / n1
                xi12 = (xi12 + sc.tau * u1y) / n1
                xi21 = (xi21 + sc.tau * u2x) / n2
                xi22 = (xi22 + sc.tau * u2y) / n2
                d1 = divergence_patch(xi11, xi12, ph, pw)
                d2 = divergence_patch(xi21, xi22, ph, pw)
                nu1 = u1 - sc.tau * (-d1 + (u1 - v1) / sc.theta)
                nu2 = u2 - sc.tau * (-d2 + (u2 - v2) / sc.theta)
                reg = (xi11, xi12, xi21, xi22)
            err = jnp.sum(
                jnp.where(inbox, (nu1 - u1) ** 2 + (nu2 - u2) ** 2, 0.0)
            ) / npx
            return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2, reg, v1, v2,
                    err, n + 1)

        def cond(st):
            return jnp.logical_and(st[7] > sc.tol * sc.tol, st[8] < max_iters)

        st = (u1, u2, u1, u2, reg_state, v1, v2,
              jnp.asarray(jnp.inf, u1.dtype), jnp.asarray(0, jnp.int32))
        st = _bounded_pd_loop(cond, body, st, max_iters)
        u1, u2, _, _, reg_state, v1, v2 = st[:7]

    # eval (tvcsad_model.cpp:87-175 / nltvcsad analogues); sanitize
    # out-of-box cells first (0*inf = NaN through the shifts)
    u1 = jnp.where(inbox, u1, 0.0)
    u2 = jnp.where(inbox, u2, 0.0)
    v1 = jnp.where(inbox, v1, 0.0)
    v2 = jnp.where(inbox, v2, 0.0)
    i1w = _warp1(sc, gx, gy, u1, u2, inbox)
    dt = jnp.zeros_like(u1)
    for j, (dy, dx) in enumerate(CSAD_OFFS):
        i0n = _shift_canvas(i0_patch, dy, dx)
        i1wn = _shift_canvas(i1w, dy, dx)
        dt = dt + jnp.where(masks[j], jnp.abs(i0_patch - i0n - i1w + i1wn), 0.0)
    dt = dt * sc.lambda_ * (w2d if weighted else 1.0)
    dc = (1.0 / (2.0 * sc.theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    if nltv_reg:
        wp2, wt2 = _nltv_crop_weights(sc, oy, ox, p, rows, cols, ph, pw)
        g = jnp.zeros_like(u1)
        for j, (dy, dx) in enumerate(NLTV_OFFS):
            g = g + wp2[j] * (
                jnp.abs(u1 - _shift_canvas(u1, dy, dx))
                + jnp.abs(u2 - _shift_canvas(u2, dy, dx))
            )
        g = g / wt2
    elif inert_tv:
        # eval_tvcsad's g reads the same never-written buffers => 0
        g = jnp.zeros_like(u1)
    else:
        u1x, u1y = forward_gradient_patch(u1, ph, pw)
        u2x, u2y = forward_gradient_patch(u2, ph, pw)
        g = jnp.sqrt(u1x * u1x + u1y * u1y + u2x * u2x + u2y * u2y)
    ener = jnp.sum(jnp.where(inbox, dc + dt + g, 0.0)) / (ph * pw)
    return u1, u2, chi, ener


# ---------------------------------------------------------------------------
# Public solver entry points (module-level => hashable as jit statics)
# ---------------------------------------------------------------------------


def solve_tvl1(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=False)


def solve_tvl1_w(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=True)


def solve_nltvl1(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_nltv_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=False)


def solve_nltvl1_w(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_nltv_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=True)


def solve_tvcsad(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=False,
                              nltv_reg=False)


def solve_tvcsad_w(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=True,
                              nltv_reg=False)


def solve_nltvcsad(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=False,
                              nltv_reg=True)


def solve_nltvcsad_w(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps, max_iters, wr):
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi,
                              p, warps, max_iters, wr, weighted=True,
                              nltv_reg=True)


def solve_tvl1_occ(sc, ci, cj, oy, ox, ph, pw, u1, u2, chi, p, warps,
                   max_iters, wr):
    """Method 8 canvas solver — delegates to core.occlusion.solve_occ_canvas
    (guided_tvl2coupled_occ, tvl2_model_occ.cpp:492-779). Note the local
    step's PD cap is params.iterations_of, not max_iter_patch (the reference
    passes iterations_of through ofD->params, :653)."""
    from faldoi_tpu.core.occlusion import solve_occ_canvas

    i0_patch = _crop_i0(sc, oy, ox, p)
    g_patch = crop_padded(sc.gpad, oy, ox, p)
    alpha, beta, mu, tau_u, tau_eta, tau_chi = (
        sc.occ_prm[0], sc.occ_prm[1], sc.occ_prm[2],
        sc.occ_prm[3], sc.occ_prm[4], sc.occ_prm[5],
    )
    return solve_occ_canvas(
        i0_patch, sc.i1, sc.i1x, sc.i1y, sc.i_1, sc.i_1x, sc.i_1y, g_patch,
        oy, ox, ph, pw, u1, u2, chi,
        sc.lambda_, sc.theta, alpha, beta, mu,
        tau_u, tau_eta, tau_chi, sc.tol, warps, max_iters,
    )


SOLVERS = {
    P.M_TVL1: solve_tvl1,
    P.M_TVL1_W: solve_tvl1_w,
    P.M_NLTVL1: solve_nltvl1,
    P.M_NLTVL1_W: solve_nltvl1_w,
    P.M_TVCSAD: solve_tvcsad,
    P.M_TVCSAD_W: solve_tvcsad_w,
    P.M_NLTVCSAD: solve_nltvcsad,
    P.M_NLTVCSAD_W: solve_nltvcsad_w,
    P.M_TVL1_OCC: solve_tvl1_occ,
}

"""TV-L1 with occlusion estimation (method 8) — Ballester et al., DAGM 2012.

Re-implementation of ``tvl2_model_occ.cpp``: the flow (u) and a binary
occlusion field (chi) are minimised jointly over three frames
(I-1, I0, I1).  Occluded pixels use the backward data term rho(I-1) with the
flow negated; the regulariser is weighted by g = 1/(1 + gamma*|grad I0|);
inner loops run 24 dual iterations for xi (flow) and for eta/chi each outer
iteration, and chi is re-binarised at 0.6 after every chi loop
(``tvl2coupled_get_chi_patch``, :411-484).

One implementation serves both domains, exactly like the reference's
``guided_tvl2coupled_occ`` (:492-779) does: the patch solver vmaps it over
(P, P) canvases with valid boxes; the global step calls it once with the
canvas = whole image (the reference's global branch passes
index = [0,w)x[0,h), global_faldoi.cpp:2161-2165).

Deviations from the reference, by design:
* ``div_u`` (the beta*chi*div(u) coupling in the chi update) is read from
  *uninitialised memory* in the reference's minimisation (it is only written
  by the energy evaluation, tvl2_model_occ.cpp:238); we compute
  div(u) from the current flow, which is the published model's intent.
* ``eta`` is likewise never initialised in the reference; we start it at 0.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from faldoi_tpu.ops.bicubic import bicubic_interp_at
from faldoi_tpu.ops.stencils import (
    centered_gradient,
    divergence_patch,
    forward_gradient_patch,
)
from faldoi_tpu.params import (
    GRAD_IS_ZERO,
    ITER_CHI,
    ITER_XI,
    PAR_DEFAULT_GAMMA,
    THRESHOLD_DELTA,
)
from faldoi_tpu import params as P


def init_weight(i0x, i0y):
    """g = 1/(1 + gamma*|grad I0|) (utils.cpp:838-852)."""
    return 1.0 / (1.0 + PAR_DEFAULT_GAMMA * jnp.sqrt(i0x * i0x + i0y * i0y))


def _warp3(img, imgx, imgy, gx, gy, u1, u2, inbox):
    """Warp (img, imgx, imgy) at the canvas cells' displaced positions with
    one 4x4x3 window gather per cell.  The same code serves the patch
    canvases and the global whole-image canvas (oy = ox = 0)."""
    su = jnp.where(inbox, u1, 0.0)
    sv = jnp.where(inbox, u2, 0.0)
    w = bicubic_interp_at(jnp.stack([img, imgx, imgy], axis=-1),
                          gx + su, gy + sv, False)
    return w[..., 0], w[..., 1], w[..., 2]


def _get_xi(xi, g, v1, v2, chix, chiy, ph, pw, theta, beta, tau_u):
    """tvl2coupled_get_xi_patch (:312-407): 24 dual iterations; returns
    updated xi and the final div(g*xi) pair."""
    tau_theta = tau_u / theta
    xi11, xi12, xi21, xi22 = xi

    def div_gxi(xi11, xi12, xi21, xi22):
        d1 = divergence_patch(g * xi11, g * xi12, ph, pw)
        d2 = divergence_patch(g * xi21, g * xi22, ph, pw)
        return d1, d2

    def body(_, st):
        xi11, xi12, xi21, xi22 = st
        d1, d2 = div_gxi(xi11, xi12, xi21, xi22)
        vi1 = v1 + theta * d1 + theta * beta * chix
        vi2 = v2 + theta * d2 + theta * beta * chiy
        g1x, g1y = forward_gradient_patch(vi1, ph, pw)
        g2x, g2y = forward_gradient_patch(vi2, ph, pw)
        vec11, vec12 = g * g1x, g * g1y
        vec21, vec22 = g * g2x, g * g2y
        n1 = jnp.sqrt(vec11 * vec11 + vec12 * vec12)
        n2 = jnp.sqrt(vec21 * vec21 + vec22 * vec22)
        xi11 = (xi11 + tau_theta * vec11) / (1.0 + tau_theta * n1)
        xi12 = (xi12 + tau_theta * vec12) / (1.0 + tau_theta * n1)
        xi21 = (xi21 + tau_theta * vec21) / (1.0 + tau_theta * n2)
        xi22 = (xi22 + tau_theta * vec22) / (1.0 + tau_theta * n2)
        return (xi11, xi12, xi21, xi22)

    st = jax.lax.fori_loop(1, ITER_XI, body, (xi11, xi12, xi21, xi22))
    d1, d2 = div_gxi(*st)
    return st, d1, d2


def _get_chi(chi, F, G, g, eta1, eta2, div_u, ph, pw, prm_mu, tau_eta,
             tau_chi, beta, inbox):
    """tvl2coupled_get_chi_patch (:411-484): 24 eta/chi iterations + 0.6
    binarisation."""
    chix, chiy = forward_gradient_patch(chi, ph, pw)

    def body(_, st):
        chi, chix, chiy, eta1, eta2 = st
        e1 = eta1 + prm_mu * tau_eta * g * chix
        e2 = eta2 + prm_mu * tau_eta * g * chiy
        ne = jnp.sqrt(e1 * e1 + e2 * e2)
        scale = jnp.where(ne <= 1.0, 1.0, ne)
        eta1, eta2 = e1 / scale, e2 / scale
        dge = divergence_patch(g * eta1, g * eta2, ph, pw)
        chi_new = chi + tau_chi * (prm_mu * dge - beta * div_u - F - G)
        chi = jnp.clip(chi_new, 0.0, 1.0)
        chix, chiy = forward_gradient_patch(chi, ph, pw)
        return (chi, chix, chiy, eta1, eta2)

    st = jax.lax.fori_loop(1, ITER_CHI, body, (chi, chix, chiy, eta1, eta2))
    chi = jnp.where(st[0] > THRESHOLD_DELTA, 1.0, 0.0)
    chi = jnp.where(inbox, chi, 0.0)
    return chi, st[3], st[4]


def solve_occ_canvas(
    i0_patch,             # I0 on the canvas
    i1_full, i1x, i1y,    # full forward frame + derivatives
    i_1_full, i_1x, i_1y, # full backward frame + derivatives
    g_patch,              # regulariser weight on the canvas
    oy, ox, ph, pw,       # canvas origin + valid box
    u1, u2, chi,          # initial state on the canvas
    prm_lambda, prm_theta, prm_alpha, prm_beta, prm_mu,
    tau_u, tau_eta, tau_chi, tol, warps, max_iters,
):
    """guided_tvl2coupled_occ (:492-779) on one canvas. Returns
    (u1, u2, chi, ener)."""
    p_h, p_w = u1.shape
    rows = jnp.arange(p_h)[:, None]
    cols = jnp.arange(p_w)[None, :]
    inbox = (rows < ph) & (cols < pw)
    gx = (ox + cols).astype(u1.dtype)
    gy = (oy + rows).astype(u1.dtype)
    l_t = prm_lambda * prm_theta

    xi = tuple(jnp.zeros_like(u1) for _ in range(4))
    eta1 = jnp.zeros_like(u1)
    eta2 = jnp.zeros_like(u1)
    v1, v2 = u1, u2

    for _ in range(warps):
        i1w, i1wx, i1wy = _warp3(i1_full, i1x, i1y, gx, gy, u1, u2, inbox)
        i_1w, i_1wx, i_1wy = _warp3(i_1_full, i_1x, i_1y, gx, gy, -u1, -u2, inbox)
        grad_1 = i1wx * i1wx + i1wy * i1wy
        grad__1 = i_1wx * i_1wx + i_1wy * i_1wy
        rho_c1 = i1w - i1wx * u1 - i1wy * u2 - i0_patch
        rho_c_1 = i_1w - i_1wx * u1 - i_1wy * u2 - i0_patch

        def body(st):
            u1, u2, chi, xi11, xi12, xi21, xi22, eta1, eta2, v1, v2, err, n = st
            rho_1 = rho_c1 + i1wx * u1 + i1wy * u2
            rho__1 = rho_c_1 + i_1wx * u1 + i_1wy * u2

            occ = chi != 0.0
            eps = jnp.where(occ, -1.0, 1.0)
            alpha_i = jnp.where(occ, 1.0 / (1.0 + prm_alpha * prm_theta), 1.0)
            mu_t = jnp.where(occ, l_t / (1.0 + prm_alpha * prm_theta), l_t)
            lam_v = jnp.where(
                occ,
                rho__1
                + prm_alpha * prm_theta / (1.0 + prm_alpha * prm_theta)
                * (u1 * i_1wx + u2 * i_1wy),
                rho_1,
            )
            grad = jnp.where(occ, grad__1, grad_1)
            iwx = jnp.where(occ, i_1wx, i1wx)
            iwy = jnp.where(occ, i_1wy, i1wy)
            rho = jnp.where(occ, rho__1, rho_1)

            small = grad < GRAD_IS_ZERO
            v_mid1 = jnp.where(small, u1, u1 - eps * rho * iwx / jnp.where(small, 1.0, grad))
            v_mid2 = jnp.where(small, u2, u2 - eps * rho * iwy / jnp.where(small, 1.0, grad))
            v1 = jnp.where(
                lam_v > mu_t * grad,
                alpha_i * u1 - mu_t * eps * iwx,
                jnp.where(lam_v < -mu_t * grad, alpha_i * u1 + mu_t * eps * iwx, v_mid1),
            )
            v2 = jnp.where(
                lam_v > mu_t * grad,
                alpha_i * u2 - mu_t * eps * iwy,
                jnp.where(lam_v < -mu_t * grad, alpha_i * u2 + mu_t * eps * iwy, v_mid2),
            )

            chix, chiy = forward_gradient_patch(chi, ph, pw)
            (xi11, xi12, xi21, xi22), d1, d2 = _get_xi(
                (xi11, xi12, xi21, xi22), g_patch, v1, v2, chix, chiy,
                ph, pw, prm_theta, prm_beta, tau_u,
            )

            nu1 = v1 + prm_theta * d1 + prm_theta * prm_beta * chix
            nu2 = v2 + prm_theta * d2 + prm_theta * prm_beta * chiy
            diff = (nu1 - u1) ** 2 + (nu2 - u2) ** 2

            rho__1v = rho_c_1 + i_1wx * v1 + i_1wy * v2
            rho_1v = rho_c1 + i1wx * v1 + i1wy * v2
            F = prm_lambda * (jnp.abs(rho__1v) - jnp.abs(rho_1v))
            G = prm_alpha / 2.0 * (v1 * v1 + v2 * v2)

            # div(u) coupling — computed from the current flow (see module
            # docstring on the reference's uninitialised div_u)
            div_u = divergence_patch(nu1, nu2, ph, pw)
            chi, eta1, eta2 = _get_chi(
                chi, F, G, g_patch, eta1, eta2, div_u, ph, pw, prm_mu,
                tau_eta, tau_chi, prm_beta, inbox,
            )

            err = jnp.max(jnp.where(inbox, diff, 0.0))
            return (nu1, nu2, chi, xi11, xi12, xi21, xi22, eta1, eta2,
                    v1, v2, err, n + 1)

        def cond(st):
            return jnp.logical_and(st[11] > tol * tol, st[12] < max_iters)

        st = (u1, u2, chi) + xi + (eta1, eta2, v1, v2,
                                   jnp.asarray(jnp.inf, u1.dtype),
                                   jnp.asarray(0, jnp.int32))
        st = jax.lax.while_loop(cond, body, st)
        u1, u2, chi = st[0], st[1], st[2]
        xi = st[3:7]
        eta1, eta2, v1, v2 = st[7], st[8], st[9], st[10]

    # energy (eval_tvl2coupled_occ, :177-304)
    u1x, u1y = forward_gradient_patch(u1, ph, pw)
    u2x, u2y = forward_gradient_patch(u2, ph, pw)
    chix, chiy = forward_gradient_patch(chi, ph, pw)
    div_u = divergence_patch(u1, u2, ph, pw)
    i1w, i1wx, i1wy = _warp3(i1_full, i1x, i1y, gx, gy, u1, u2, inbox)
    i_1w, i_1wx, i_1wy = _warp3(i_1_full, i_1x, i_1y, gx, gy, -u1, -u2, inbox)
    diff_uv = (1.0 / (2.0 * prm_theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    norm_v = (prm_alpha / 2.0) * chi * (v1 * v1 + v2 * v2)
    div_u_t = prm_beta * chi * div_u
    rho_1 = jnp.abs(i1w - i1wx * u1 - i1wy * u2 - i0_patch + i1wx * v1 + i1wy * v2)
    rho__1 = jnp.abs(i_1w - i_1wx * u1 - i_1wy * u2 - i0_patch + i_1wx * v1 + i_1wy * v2)
    data = prm_lambda * ((1.0 - chi) * rho_1 + chi * rho__1)
    smooth = g_patch * (
        jnp.sqrt(u1x * u1x + u1y * u1y)
        + jnp.sqrt(u2x * u2x + u2y * u2y)
        + prm_mu * jnp.sqrt(chix * chix + chiy * chiy)
    )
    ener = jnp.sum(
        jnp.where(inbox, data + smooth + div_u_t + norm_v + diff_uv, 0.0)
    ) / (ph * pw)
    return u1, u2, chi, ener


@functools.partial(
    jax.jit,
    static_argnames=("prm_lambda", "prm_theta", "prm_alpha", "prm_beta",
                     "prm_mu", "tau_u", "tau_eta", "tau_chi", "tol", "warps",
                     "max_iters"),
)
def _occ_global_jit(i0n, i1n, i_1n, u1, u2, chi,
                    prm_lambda, prm_theta, prm_alpha, prm_beta, prm_mu,
                    tau_u, tau_eta, tau_chi, tol, warps, max_iters):
    h, w = i0n.shape
    i1x, i1y = centered_gradient(i1n)
    i_1x, i_1y = centered_gradient(i_1n)
    i0x, i0y = centered_gradient(i0n)
    g = init_weight(i0x, i0y)
    return solve_occ_canvas(
        i0n, i1n, i1x, i1y, i_1n, i_1x, i_1y, g,
        0, 0, h, w, u1, u2, chi,
        prm_lambda, prm_theta, prm_alpha, prm_beta, prm_mu,
        tau_u, tau_eta, tau_chi, tol, warps, max_iters,
    )


def tvl2_occ_global(i0n, i1n, i_1n, u1, u2, occ_init, prm: P.Parameters):
    """Global-step entry (global_faldoi.cpp:2161-2165). Returns (u1,u2,chi)."""
    chi = (
        jnp.zeros_like(u1)
        if occ_init is None
        else jnp.asarray(np.asarray(occ_init, np.float32))
    )
    u1, u2, chi, _ = _occ_global_jit(
        i0n, i1n, i_1n, u1, u2, chi,
        prm.lambda_, prm.theta, prm.alpha, prm.beta, prm.mu,
        prm.tau_u, prm.tau_eta, prm.tau_chi, prm.tol_OF, prm.warps,
        prm.iterations_of,
    )
    return u1, u2, chi

"""CSAD-family patch solvers vs faithful NumPy transliterations.

Transliterates the reference patch solvers loop-for-loop:

* ``guided_tvcsad``  (tvcsad_model.cpp:265-477) INCLUDING its quirk that the
  flow-gradient buffers fed to tvcsad_getD are never written (allocated at
  :38-41, only read at :255/:135 — zero pages in practice), so the TV duals
  stay 0 and eval's g term is 0;
* ``guided_nltvcsad`` (nltvcsad_model.cpp:297-516) with cold duals (the
  reference warm-starts image-wide duals across solves — a serial side
  effect; cold-vs-cold isolates the solver math).

Both run on a crop of the seeded pair with a known-flow-perturbed init and must match
our canvas solvers to float tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from faldoi_tpu.core.preprocess import prepare_pair
from faldoi_tpu.core.functionals import (
    SOLVERS, make_solver_consts, NLTV_OFFS, CSAD_OFFS,
)
from faldoi_tpu.models import method_local_params
from faldoi_tpu.ops.stencils import centered_gradient
from faldoi_tpu.core.patch_solver import pad_for_crops
from faldoi_tpu import params as P
from tests.ref_numpy import bicubic_at

CROP = (100, 300, 64, 64)
WR, PATCH = 5, 11
TOL, MAXIT, WARPS = 0.01, 4, 1


def _warp_patch(img, u1, u2, oy, ox):
    """bicubic_interpolation_warp_patch over the patch box (border_out
    false)."""
    out = np.zeros((PATCH, PATCH), np.float32)
    for r in range(PATCH):
        for c in range(PATCH):
            out[r, c] = bicubic_at(
                img, ox + c + u1[r, c], oy + r + u2[r, c], False
            )
    return out


def _csad_b_and_grad(i0, i1w, i1wx, i1wy, u1, u2, l_t):
    grad = np.hypot(i1wx * i1wx + i1wy * i1wy, 0.01)
    nd = len(CSAD_OFFS)
    b = np.zeros((nd, PATCH, PATCH), np.float32)
    valid = np.zeros((nd, PATCH, PATCH), bool)
    for j, (dy, dx) in enumerate(CSAD_OFFS):
        for r in range(PATCH):
            for c in range(PATCH):
                rr, cc = r + dy, c + dx
                if 0 <= rr < PATCH and 0 <= cc < PATCH:
                    valid[j, r, c] = True
                    b[j, r, c] = (
                        i0[r, c] - i0[rr, cc] - i1w[r, c] + i1w[rr, cc]
                        + i1wx[r, c] * u1[r, c] + i1wy[r, c] * u2[r, c]
                    ) / grad[r, c]
    return b, valid, grad


def _csad_vstep(u1, u2, b, valid, grad, i1wx, i1wy, l_t):
    v1 = np.zeros_like(u1)
    v2 = np.zeros_like(u2)
    for r in range(PATCH):
        for c in range(PATCH):
            ba = []
            for j in range(b.shape[0]):
                if valid[j, r, c]:
                    ba.append(-(b[j, r, c] - (i1wx[r, c] * u1[r, c]
                                              + i1wy[r, c] * u2[r, c])
                                / grad[r, c]))
            n = len(ba)
            for j in range(n + 1):
                ba.append((n - 2 * j) * l_t * grad[r, c])
            ba.sort()
            it = len(ba)  # 2n+1
            med = ba[it // 2 + 1]
            v1[r, c] = u1[r, c] - i1wx[r, c] * med / grad[r, c]
            v2[r, c] = u2[r, c] - i1wy[r, c] * med / grad[r, c]
    return v1, v2


def ref_guided_tvcsad(i0, i1, u1, u2, oy, ox, lam, theta, tau):
    """tvcsad_model.cpp:265-477 with the zero-gradient-buffer quirk: the
    duals never move, so getP reduces to the v-pull and eval's g is 0."""
    i1x_full, i1y_full = (np.asarray(a) for a in centered_gradient(
        jnp.asarray(i1)))
    l_t = lam * theta
    u1, u2 = u1.copy(), u2.copy()
    for _ in range(WARPS):
        i1w = _warp_patch(i1, u1, u2, oy, ox)
        i1wx = _warp_patch(i1x_full, u1, u2, oy, ox)
        i1wy = _warp_patch(i1y_full, u1, u2, oy, ox)
        b, valid, grad = _csad_b_and_grad(i0, i1w, i1wx, i1wy, u1, u2, l_t)
        err, n = np.inf, 0
        while err > TOL * TOL and n < MAXIT:
            n += 1
            v1, v2 = _csad_vstep(u1, u2, b, valid, grad, i1wx, i1wy, l_t)
            # tvcsad_getD fed never-written buffers => duals stay 0,
            # div_xi == 0
            nu1 = u1 - tau * ((u1 - v1) / theta)
            nu2 = u2 - tau * ((u2 - v2) / theta)
            err = (((nu1 - u1) ** 2 + (nu2 - u2) ** 2).sum()
                   / (PATCH * PATCH))
            u1, u2 = nu1, nu2
    # eval_tvcsad (:87-175); g reads the same zero buffers
    i1w = _warp_patch(i1, u1, u2, oy, ox)
    dc = (1 / (2 * theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    dt = np.zeros_like(u1)
    for j, (dy, dx) in enumerate(CSAD_OFFS):
        for r in range(PATCH):
            for c in range(PATCH):
                rr, cc = r + dy, c + dx
                if 0 <= rr < PATCH and 0 <= cc < PATCH:
                    dt[r, c] += abs(i0[r, c] - i0[rr, cc]
                                    - i1w[r, c] + i1w[rr, cc])
    ener = (dc + lam * dt).sum() / (PATCH * PATCH)
    return u1, u2, ener


def ref_guided_nltvcsad(i0, i1, u1, u2, wp, oy, ox, lam, theta, tau):
    """nltvcsad_model.cpp:297-516, cold duals.  ``wp`` is (24, P, P) —
    weights at each patch pixel for the 24 NLTV_OFFS neighbours."""
    i1x_full, i1y_full = (np.asarray(a) for a in centered_gradient(
        jnp.asarray(i1)))
    l_t = lam * theta
    nd = len(NLTV_OFFS)
    u1, u2 = u1.copy(), u2.copy()
    sc_p = np.zeros((nd, PATCH, PATCH), np.float32)
    sc_q = np.zeros((nd, PATCH, PATCH), np.float32)

    def nb_valid(j, r, c):
        dy, dx = NLTV_OFFS[j]
        rr, cc = r + dy, c + dx
        return (0 <= rr < PATCH and 0 <= cc < PATCH), rr, cc

    for _ in range(WARPS):
        i1w = _warp_patch(i1, u1, u2, oy, ox)
        i1wx = _warp_patch(i1x_full, u1, u2, oy, ox)
        i1wy = _warp_patch(i1y_full, u1, u2, oy, ox)
        b, valid, grad = _csad_b_and_grad(i0, i1w, i1wx, i1wy, u1, u2, l_t)
        # patch-restricted wt (nltvcsad_model.cpp:400-432)
        wt = np.zeros((PATCH, PATCH), np.float32)
        for r in range(PATCH):
            for c in range(PATCH):
                for j in range(nd):
                    ok, _, _ = nb_valid(j, r, c)
                    if ok:
                        wt[r, c] += wp[j, r, c]
        u1_, u2_ = u1.copy(), u2.copy()
        err, n = np.inf, 0
        while err > TOL * TOL and n < MAXIT:
            n += 1
            v1, v2 = _csad_vstep(u1, u2, b, valid, grad, i1wx, i1wy, l_t)
            # nltvcsad_getD (:233-296) on the over-relaxed u1_
            for r in range(PATCH):
                for c in range(PATCH):
                    for j in range(nd):
                        ok, rr, cc = nb_valid(j, r, c)
                        if ok:
                            nlgr1 = wp[j, r, c] * (u1_[r, c] - u1_[rr, cc]) \
                                / wt[r, c]
                            nlgr2 = wp[j, r, c] * (u2_[r, c] - u2_[rr, cc]) \
                                / wt[r, c]
                            sc_p[j, r, c] = (sc_p[j, r, c] + tau * nlgr1) \
                                / (1 + tau * abs(nlgr1))
                            sc_q[j, r, c] = (sc_q[j, r, c] + tau * nlgr2) \
                                / (1 + tau * abs(nlgr2))
            # non_local_divergence (aux_energy_model.cpp:178-212)
            div_p = np.zeros((PATCH, PATCH), np.float32)
            div_q = np.zeros((PATCH, PATCH), np.float32)
            for r in range(PATCH):
                for c in range(PATCH):
                    for j in range(nd):
                        ok, rr, cc = nb_valid(j, r, c)
                        if ok:
                            rp = nd - 1 - j  # mirrored neighbour index
                            div_p[r, c] += wp[j, r, c] * (
                                sc_p[j, r, c] - sc_p[rp, rr, cc])
                            div_q[r, c] += wp[j, r, c] * (
                                sc_q[j, r, c] - sc_q[rp, rr, cc])
            # nltvcsad_getP (:187-231): note +div (not -div)
            nu1 = u1 - tau * (div_p + (u1 - v1) / theta)
            nu2 = u2 - tau * (div_q + (u2 - v2) / theta)
            err = (((nu1 - u1) ** 2 + (nu2 - u2) ** 2).sum()
                   / (PATCH * PATCH))
            u1_, u2_ = 2 * nu1 - u1, 2 * nu2 - u2
            u1, u2 = nu1, nu2
    # eval_nltvcsad (:70-149)
    i1w = _warp_patch(i1, u1, u2, oy, ox)
    dc = (1 / (2 * theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    g = np.zeros_like(u1)
    dt = np.zeros_like(u1)
    for r in range(PATCH):
        for c in range(PATCH):
            for j in range(nd):
                ok, rr, cc = nb_valid(j, r, c)
                if ok:
                    g[r, c] += wp[j, r, c] * (
                        abs(u1[r, c] - u1[rr, cc])
                        + abs(u2[r, c] - u2[rr, cc]))
            g[r, c] /= wt[r, c]
    for j, (dy, dx) in enumerate(CSAD_OFFS):
        for r in range(PATCH):
            for c in range(PATCH):
                rr, cc = r + dy, c + dx
                if 0 <= rr < PATCH and 0 <= cc < PATCH:
                    dt[r, c] += abs(i0[r, c] - i0[rr, cc]
                                    - i1w[r, c] + i1w[rr, cc])
    ener = (dc + lam * dt + g).sum() / (PATCH * PATCH)
    return u1, u2, ener


@pytest.fixture(scope="module")
def crop():
    from tests import seeded

    i0p, i1p, gt = seeded.pair(CROP)
    a, b = prepare_pair(i0p, i1p)
    return np.asarray(a), np.asarray(b), gt, i0p


@pytest.mark.parametrize("method", [P.M_TVCSAD, P.M_NLTVCSAD])
def test_csad_solver_matches_transliteration(crop, method):
    a, b, gt, i0p = crop
    oy, ox = 24, 24
    rng = np.random.RandomState(0)
    u1 = (gt[oy:oy + PATCH, ox:ox + PATCH, 0]
          + 0.1 * rng.randn(PATCH, PATCH)).astype(np.float32)
    u2 = (gt[oy:oy + PATCH, ox:ox + PATCH, 1]
          + 0.1 * rng.randn(PATCH, PATCH)).astype(np.float32)
    lam, theta, tau = method_local_params(method, WR)

    i1x, i1y = centered_gradient(jnp.asarray(b))
    sc = make_solver_consts(
        method, pad_for_crops(jnp.asarray(a), PATCH), jnp.asarray(b),
        i1x, i1y, lam, theta, tau, TOL, wr=WR,
        i0_planes=i0p if method == P.M_NLTVCSAD else None, p=PATCH,
    )
    ci, cj = ox + WR, oy + WR
    su, sv, _, ener = SOLVERS[method](
        sc, ci, cj, oy, ox, PATCH, PATCH,
        jnp.asarray(u1), jnp.asarray(u2), jnp.zeros((PATCH, PATCH)),
        PATCH, WARPS, MAXIT, WR,
    )

    i0_patch = a[oy:oy + PATCH, ox:ox + PATCH]
    if method == P.M_TVCSAD:
        ru1, ru2, rener = ref_guided_tvcsad(
            i0_patch, b, u1, u2, oy, ox, lam, theta, tau)
    else:
        wp = np.asarray(sc.wp_pad[:, oy:oy + PATCH, ox:ox + PATCH])
        ru1, ru2, rener = ref_guided_nltvcsad(
            i0_patch, b, u1, u2, wp, oy, ox, lam, theta, tau)

    np.testing.assert_allclose(np.asarray(su), ru1, atol=2e-4,
                               err_msg=f"m{method} u1")
    np.testing.assert_allclose(np.asarray(sv), ru2, atol=2e-4,
                               err_msg=f"m{method} u2")
    np.testing.assert_allclose(float(ener), rener, rtol=2e-3,
                               err_msg=f"m{method} energy")

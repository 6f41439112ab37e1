"""Batched per-patch TV-L1 primal-dual solver.

Batched form of the local step's per-seed solves (``guided_tvl2coupled``,
``tvl2_model.cpp:249-435`` + ``eval_tvl2coupled`` ``:174-243``): instead of
one scalar patch solve per priority-queue pop, we solve *all* patches of a
wavefront sweep simultaneously — each patch lives on a static (P, P) canvas
with a dynamic valid box, and the whole solver is ``vmap``-ed and jitted into
a single fused XLA program.

Reference semantics preserved:

* patch warps use ``border_out=false`` (clamped extrapolation),
* duals are zeroed per solve,
* the patch box edge acts as the image edge for gradients/divergence
  (see ops.stencils patch variants),
* the while-loop runs until max-update < tol^2 or ``max_iter_patch`` (4),
* the returned energy is eval_tvl2coupled's patch mean (data + coupling + TV)
  computed from the final state.

Deliberate deviation: the reference's ``divergence_patch`` leaves stale
values on interior-patch edges due to absolute-coordinate boundary writes
(utils.cpp:90-105); we compute the intended Chambolle boundary values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from faldoi_tpu.ops.bicubic import bicubic_interp_at
from faldoi_tpu.ops.stencils import divergence_patch, forward_gradient_patch
from faldoi_tpu.core.pd_common import tvl1_threshold, tvl2_getD, tvl2_getP


class PatchBatch(NamedTuple):
    """A wavefront batch of patches.

    oy, ox: (B,) int32 canvas origins (top-left of the clamped patch box).
    ph, pw: (B,) int32 valid box sizes.
    u1, u2: (B, P, P) flow canvases (init values; NaN-free inside the box).
    """

    oy: jnp.ndarray
    ox: jnp.ndarray
    ph: jnp.ndarray
    pw: jnp.ndarray
    u1: jnp.ndarray
    u2: jnp.ndarray


def crop_canvas(img: jnp.ndarray, oy, ox, p: int):
    """Gather a (P, P) canvas from ``img`` at origin (oy, ox), clamping reads
    to the image (out-of-box canvas cells are junk and must stay masked)."""
    h, w = img.shape
    rows = jnp.clip(oy + jnp.arange(p)[:, None], 0, h - 1)
    cols = jnp.clip(ox + jnp.arange(p)[None, :], 0, w - 1)
    return img[rows, cols]


def pad_for_crops(img: jnp.ndarray, p: int) -> jnp.ndarray:
    """Edge-pad bottom/right by p so crop_padded() can use dynamic_slice
    (equivalent to the clamped gather for non-negative origins)."""
    return jnp.pad(img, ((0, p), (0, p)), mode="edge")


def crop_padded(img_pad: jnp.ndarray, oy, ox, p: int):
    """(p, p, *chans) dynamic_slice crop at (oy, ox) from a padded
    (H, W, *chans) stack (pad_for_crops() for one plane).  Under vmap this
    is one batched gather; values are copied bit for bit."""
    chans = img_pad.shape[2:]
    return jax.lax.dynamic_slice(
        img_pad, (oy, ox) + (0,) * len(chans), (p, p) + chans)


def _solve_one(
    i1_full,
    i1x_full,
    i1y_full,
    i0_patch,
    oy,
    ox,
    ph,
    pw,
    u1,
    u2,
    lambda_,
    theta,
    tau,
    tol,
    warps,
    max_iters,
    p,
):
    l_t = lambda_ * theta
    rows = jnp.arange(p)[:, None]
    cols = jnp.arange(p)[None, :]
    inbox = (rows < ph) & (cols < pw)
    gx = (ox + cols).astype(u1.dtype)  # global x of each canvas cell
    gy = (oy + rows).astype(u1.dtype)

    def warp3(u1, u2):
        # guard: keep sample coordinates finite for masked-out cells
        su = jnp.where(inbox, u1, 0.0)
        sv = jnp.where(inbox, u2, 0.0)
        i1w = bicubic_interp_at(i1_full, gx + su, gy + sv, False)
        i1wx = bicubic_interp_at(i1x_full, gx + su, gy + sv, False)
        i1wy = bicubic_interp_at(i1y_full, gx + su, gy + sv, False)
        return i1w, i1wx, i1wy

    xi11 = jnp.zeros_like(u1)
    xi12 = jnp.zeros_like(u1)
    xi21 = jnp.zeros_like(u1)
    xi22 = jnp.zeros_like(u1)
    v1 = u1
    v2 = u2

    for _ in range(warps):
        i1w, i1wx, i1wy = warp3(u1, u2)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0_patch

        def body(state):
            u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, v1, v2, err, n = state
            v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
            u1x, u1y = forward_gradient_patch(u1_, ph, pw)
            u2x, u2y = forward_gradient_patch(u2_, ph, pw)
            xi11, xi12, xi21, xi22 = tvl2_getD(
                xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, tau
            )
            div1 = divergence_patch(xi11, xi12, ph, pw)
            div2 = divergence_patch(xi21, xi22, ph, pw)
            nu1, nu2, u_n = tvl2_getP(u1, u2, v1, v2, div1, div2, theta, tau)
            err = jnp.max(jnp.where(inbox, u_n, 0.0))
            u1_ = 2.0 * nu1 - u1
            u2_ = 2.0 * nu2 - u2
            return (nu1, nu2, u1_, u2_, xi11, xi12, xi21, xi22, v1, v2, err, n + 1)

        def cond(state):
            return jnp.logical_and(state[10] > tol * tol, state[11] < max_iters)

        state = (
            u1, u2, u1, u2, xi11, xi12, xi21, xi22, v1, v2,
            jnp.asarray(jnp.inf, u1.dtype), jnp.asarray(0, jnp.int32),
        )
        state = jax.lax.while_loop(cond, body, state)
        u1, u2, _, _, xi11, xi12, xi21, xi22, v1, v2 = state[:10]

    # eval_tvl2coupled (tvl2_model.cpp:174-243) on the final state
    u1x, u1y = forward_gradient_patch(u1, ph, pw)
    u2x, u2y = forward_gradient_patch(u2, ph, pw)
    i1w, _, _ = warp3(u1, u2)
    dt = lambda_ * jnp.abs(i1w - i0_patch)
    dc = (1.0 / (2.0 * theta)) * ((u1 - v1) ** 2 + (u2 - v2) ** 2)
    g = jnp.sqrt(u1x * u1x + u1y * u1y + u2x * u2x + u2y * u2y)
    ener = jnp.sum(jnp.where(inbox, dc + dt + g, 0.0)) / (ph * pw)
    return u1, u2, ener


@functools.partial(
    jax.jit, static_argnames=("lambda_", "theta", "tau", "tol", "warps", "max_iters")
)
def solve_patch_batch(
    i1_full: jnp.ndarray,
    i1x_full: jnp.ndarray,
    i1y_full: jnp.ndarray,
    i0_full: jnp.ndarray,
    batch: PatchBatch,
    lambda_: float = 40.0,
    theta: float = 0.3,
    tau: float = 0.125,
    tol: float = 0.01,
    warps: int = 1,
    max_iters: int = 4,
):
    """Solve all patches in the batch. Returns (u1, u2, ener) with
    u* of shape (B, P, P) and ener of shape (B,)."""
    p = batch.u1.shape[-1]

    def one(oy, ox, ph, pw, u1, u2):
        i0_patch = crop_canvas(i0_full, oy, ox, p)
        return _solve_one(
            i1_full, i1x_full, i1y_full, i0_patch,
            oy, ox, ph, pw, u1, u2,
            lambda_, theta, tau, tol, warps, max_iters, p,
        )

    return jax.vmap(one)(batch.oy, batch.ox, batch.ph, batch.pw, batch.u1, batch.u2)

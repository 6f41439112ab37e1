"""Global (whole-image) variational refinement — reference "Algorithm 8".

JAX rewrite of ``global_faldoi.cpp``'s solvers: each functional's
warping loop is a Python loop over ``lax.while_loop`` PD iterations, jitted
as one XLA program.  Per iteration the TV-L1 solver does ~8 stencil passes
over the image (v-threshold, 2 forward gradients, getD, 2 divergences, getP,
over-relaxation) which XLA fuses into a handful of HBM-bandwidth-bound
passes; the warps re-run bicubic gathers.

Reference behavior notes:

* The global binary warps with ``border_out=true`` (``global_faldoi.cpp:635``)
  — out-of-domain pixels get I1w = 0.
* Dual variables are zeroed once before all warps (``global_faldoi.cpp:2116``),
  not per warp as the local patch solver does.
* The iteration cap is the compiled MAX_ITERATIONS_GLOBAL=400
  (``global_faldoi.cpp:684``); the binary's ``-glb_iters`` flag is parsed but
  never reaches tvl2OF — we reproduce the default but expose the knob.
* Weighted variants fall back to their unweighted global solver
  (``global_faldoi.cpp:2132-2158``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from faldoi_tpu.ops import (
    bicubic_warp,
    centered_gradient,
    divergence,
    forward_gradient,
)
from faldoi_tpu.ops.bicubic import bicubic_warp_stack
from faldoi_tpu.core.pd_common import (
    tvl1_threshold,
    tvl2_getD,
    tvl2_getP,
    warp_constants,
)
from faldoi_tpu.params import MAX_ITERATIONS_GLOBAL


@functools.partial(jax.jit, static_argnames=("warps", "max_iters"))
def tvl2_global(
    i0: jnp.ndarray,
    i1: jnp.ndarray,
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    lambda_: float = 40.0,
    theta: float = 0.3,
    tau: float = 0.125,
    tol: float = 0.01,
    warps: int = 5,
    max_iters: int = MAX_ITERATIONS_GLOBAL,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """TV-L2-coupled global refinement (``tvl2OF``, global_faldoi.cpp:556-882).

    i0, i1: normalized+smoothed gray frames (h, w).  u1, u2: initial flow.
    Returns the refined (u1, u2).
    """
    l_t = lambda_ * theta
    i1x, i1y = centered_gradient(i1)
    i1_stack = jnp.stack([i1, i1x, i1y])

    xi11 = jnp.zeros_like(u1)
    xi12 = jnp.zeros_like(u1)
    xi21 = jnp.zeros_like(u1)
    xi22 = jnp.zeros_like(u1)

    def pd_iteration(state):
        u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, err, n, consts = state
        i1w, i1wx, i1wy, grad, rho_c = consts
        v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
        u1x, u1y = forward_gradient(u1_)
        u2x, u2y = forward_gradient(u2_)
        xi11, xi12, xi21, xi22 = tvl2_getD(
            xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, tau
        )
        div_xi1 = divergence(xi11, xi12)
        div_xi2 = divergence(xi21, xi22)
        nu1, nu2, u_n = tvl2_getP(u1, u2, v1, v2, div_xi1, div_xi2, theta, tau)
        err = jnp.max(u_n)
        u1_ = 2.0 * nu1 - u1
        u2_ = 2.0 * nu2 - u2
        return (nu1, nu2, u1_, u2_, xi11, xi12, xi21, xi22, err, n + 1, consts)

    def pd_cond(state):
        err, n = state[8], state[9]
        return jnp.logical_and(err > tol * tol, n < max_iters)

    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_warp_stack(i1_stack, u1, u2, True)
        grad, rho_c = warp_constants(i0, i1w, i1wx, i1wy, u1, u2)
        consts = (i1w, i1wx, i1wy, grad, rho_c)
        state = (
            u1,
            u2,
            u1,
            u2,
            xi11,
            xi12,
            xi21,
            xi22,
            jnp.asarray(jnp.inf, u1.dtype),
            jnp.asarray(0, jnp.int32),
            consts,
        )
        state = jax.lax.while_loop(pd_cond, pd_iteration, state)
        u1, u2, _, _, xi11, xi12, xi21, xi22 = state[:8]

    return u1, u2

"""Flow pruning between local-growing iterations.

Dense forms of ``local_faldoi.cpp``:

* ``fb_consistency_check`` (:167-190): |u_fwd(x) + u_bwd(x + u_fwd(x))| > eps
  => untrusted, with the backward flow sampled by bicubic warping
  (border_out=True).
* ``too_uniform_areas`` (:131-151): flags pixels whose 3x3 neighbourhood has
  max |I - I(center)| < tol in either frame (disabled by default, p=[1,0],
  local_faldoi.cpp:1154).
* ``delete_not_trustable`` (:283-311): untrusted pixels get NaN flow,
  infinite energy and chi=1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from faldoi_tpu.ops.bicubic import bicubic_warp, bicubic_warp_stack


@jax.jit
def fb_consistency_check(u1, u2, bu1, bu2, epsilon):
    """Returns trust mask (1 trusted / 0 occluded) for the forward flow
    (u1, u2) given the backward flow (bu1, bu2)."""
    # flows are dense at prune time; residual non-finites read as 0
    bstack = jnp.stack([jnp.nan_to_num(bu1), jnp.nan_to_num(bu2)])
    u1w, u2w = bicubic_warp_stack(bstack, u1, u2, True)
    tol = jnp.hypot(u1 + u1w, u2 + u2w)
    return (tol <= epsilon).astype(jnp.int32)


def _too_uniform(img, tol):
    """1 where the 3x3 neighbourhood (excluding center handled as in C: all 9
    positions incl. center, |center-center|=0 < tol always considered) is too
    uniform (local_faldoi.cpp:79-115)."""
    pads = jnp.pad(img, 1, mode="edge")
    diffs = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = pads[1 + dy : 1 + dy + img.shape[0], 1 + dx : 1 + dx + img.shape[1]]
            diffs.append(jnp.abs(n - img))
    return (jnp.max(jnp.stack(diffs), axis=0) < tol).astype(jnp.int32)


@jax.jit
def too_uniform_areas(a, b, u1, u2, tol):
    """Trust mask from the uniformity test on frame a and warped frame b
    (local_faldoi.cpp:131-151)."""
    bw = bicubic_warp(b, u1, u2, True)
    bad = (_too_uniform(a, tol) == 1) | (_too_uniform(bw, tol) == 1)
    return (~bad).astype(jnp.int32)


def prune(i0n, i1n, fwd_flow, bwd_flow, epsilon, use_fb=True, use_tu=False,
          tu_tol=0.01):
    """pruning_method (local_faldoi.cpp:209-270): returns (trust_go, trust_ba)."""
    h, w = i0n.shape
    trust_go = jnp.ones((h, w), jnp.int32)
    trust_ba = jnp.ones((h, w), jnp.int32)
    if use_fb:
        trust_go = trust_go * fb_consistency_check(
            fwd_flow[..., 0], fwd_flow[..., 1], bwd_flow[..., 0], bwd_flow[..., 1],
            epsilon,
        )
        trust_ba = trust_ba * fb_consistency_check(
            bwd_flow[..., 0], bwd_flow[..., 1], fwd_flow[..., 0], fwd_flow[..., 1],
            epsilon,
        )
    if use_tu:
        trust_go = trust_go * too_uniform_areas(
            i0n, i1n, fwd_flow[..., 0], fwd_flow[..., 1], tu_tol
        )
        trust_ba = trust_ba * too_uniform_areas(
            i0n, i1n, bwd_flow[..., 0], bwd_flow[..., 1], tu_tol
        )
    return trust_go, trust_ba

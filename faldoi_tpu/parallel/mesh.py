"""Multi-chip scale-out over a jax.sharding.Mesh.

The reference has no distributed backend (SURVEY §2.6): its parallelism is
OpenMP threads (subsumed here by XLA vectorisation) and spatial partitions
(``-split_img``).  The scaling axes here are:

* **data parallelism** over frame pairs (axis ``data``): each chip solves
  whole pairs; no collectives inside a solve.  This is the production
  throughput axis — optical flow over a video/dataset is embarrassingly
  parallel across pairs.
* **spatial parallelism** (axis ``space``): one frame's rows sharded across
  chips, with 1-row halo exchanges (``ppermute``) around each PD
  iteration's stencils — the replacement for the reference's
  ``-split_img`` partition threads (``aux_partitions.cpp``), with halos
  instead of the reference's seam-avoiding grid transposes.

Both compose in a 2-D mesh ('data', 'space').
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from faldoi_tpu.core.pd_common import tvl1_threshold, tvl2_getD, tvl2_getP, warp_constants
from faldoi_tpu.ops import bicubic_warp, centered_gradient


def make_mesh(n_data: int, n_space: int = 1) -> Mesh:
    devs = np.array(jax.devices()[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(devs, ("data", "space"))


# ---------------------------------------------------------------------------
# Data parallelism: batch of frame pairs sharded over 'data'.
# ---------------------------------------------------------------------------


def dp_global_refine(mesh: Mesh, i0b, i1b, u1b, u2b, warps=2, iters=40,
                     lambda_=40.0, theta=0.3, tau=0.125):
    """Batched TV-L1 global refinement, batch axis sharded over 'data'.

    A fixed-iteration variant of core.global_step.tvl2_global (early-exit
    tolerances don't batch well across shards)."""

    def one(i0, i1, u1, u2):
        i1x, i1y = centered_gradient(i1)
        xi = [jnp.zeros_like(u1) for _ in range(4)]
        l_t = lambda_ * theta
        for _ in range(warps):
            i1w = bicubic_warp(i1, u1, u2, True)
            i1wx = bicubic_warp(i1x, u1, u2, True)
            i1wy = bicubic_warp(i1y, u1, u2, True)
            grad, rho_c = warp_constants(i0, i1w, i1wx, i1wy, u1, u2)

            def body(_, st):
                u1, u2, u1_, u2_, xi11, xi12, xi21, xi22 = st
                v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
                from faldoi_tpu.ops import divergence, forward_gradient

                u1x, u1y = forward_gradient(u1_)
                u2x, u2y = forward_gradient(u2_)
                xi11, xi12, xi21, xi22 = tvl2_getD(
                    xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, tau
                )
                d1 = divergence(xi11, xi12)
                d2 = divergence(xi21, xi22)
                nu1, nu2, _ = tvl2_getP(u1, u2, v1, v2, d1, d2, theta, tau)
                return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2,
                        xi11, xi12, xi21, xi22)

            st = (u1, u2, u1, u2, *xi)
            st = jax.lax.fori_loop(0, iters, body, st)
            u1, u2 = st[0], st[1]
            xi = list(st[4:8])
        return u1, u2

    sh = NamedSharding(mesh, PS("data"))
    i0b, i1b, u1b, u2b = (jax.device_put(x, sh) for x in (i0b, i1b, u1b, u2b))
    fn = jax.jit(jax.vmap(one), in_shardings=(sh, sh, sh, sh),
                 out_shardings=(sh, sh))
    return fn(i0b, i1b, u1b, u2b)


# ---------------------------------------------------------------------------
# Spatial parallelism: rows of one frame sharded over 'space', halo exchange.
# ---------------------------------------------------------------------------


def _halo_exchange_rows(x, axis_name):
    """Append the neighbour shards' boundary rows: returns x padded with one
    row from the shard above (top) and below (bottom); edge shards replicate
    their own edge row (Neumann-consistent)."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    # send my first row up / my last row down
    from_below = jax.lax.ppermute(  # row that lives just below my last row
        x[:1], axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    from_above = jax.lax.ppermute(  # row just above my first row
        x[-1:], axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    top = jnp.where(idx == 0, x[:1], from_above)
    bot = jnp.where(idx == n - 1, x[-1:], from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def _fwd_grad_sharded(f, axis_name):
    """forward_gradient with the y-derivative crossing shard boundaries; the
    global last row gets fy=0 (mask via axis_index)."""
    fx = jnp.concatenate([f[:, 1:] - f[:, :-1], jnp.zeros_like(f[:, :1])], axis=1)
    fpad = _halo_exchange_rows(f, axis_name)
    fy = fpad[2:, :] - fpad[1:-1, :]
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    rows = jnp.arange(f.shape[0])[:, None]
    is_global_last = (idx == n - 1) & (rows == f.shape[0] - 1)
    fy = jnp.where(is_global_last, 0.0, fy)
    return fx, fy


def _divergence_sharded(v1, v2, axis_name):
    """Chambolle divergence with the y-difference crossing shard boundaries."""
    dx = jnp.concatenate(
        [v1[:, :1], v1[:, 1:-1] - v1[:, :-2], -v1[:, -2:-1]], axis=1
    )
    vpad = _halo_exchange_rows(v2, axis_name)
    dy_mid = vpad[1:-1, :] - vpad[:-2, :]
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    rows = jnp.arange(v1.shape[0])[:, None]
    first = (idx == 0) & (rows == 0)
    last = (idx == n - 1) & (rows == v1.shape[0] - 1)
    dy = jnp.where(first, v2, jnp.where(last, -vpad[:-2, :], dy_mid))
    return dx + dy


def _halo_exchange_band(x, d: int, axis_name):
    """Append ``d`` boundary rows from each row-neighbour shard (leading
    axis): returns (d + hs + d, ...) with the global edge shards replicating
    their own edge row (Neumann-consistent, matching the C clamp)."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    from_below = jax.lax.ppermute(  # the d rows just below my last row
        x[:d], axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    from_above = jax.lax.ppermute(  # the d rows just above my first row
        x[-d:], axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    rep_top = jnp.broadcast_to(x[:1], (d,) + x.shape[1:])
    rep_bot = jnp.broadcast_to(x[-1:], (d,) + x.shape[1:])
    top = jnp.where(idx == 0, rep_top, from_above)
    bot = jnp.where(idx == n - 1, rep_bot, from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def spatial_tvl2_global(mesh: Mesh, i0, i1, u1, u2, iters=40, warps=1,
                        lambda_=40.0, theta=0.3, tau=0.125,
                        max_disp: int = 16):
    """TV-L1 global refinement with H sharded over the 'space' axis —
    frames INCLUDED: nothing is replicated.

    Per warp, each shard samples the warped frame from its own rows plus a
    ``max_disp``-row halo band ppermuted from the row-neighbour shards (the
    bicubic stencil adds 2 rows, included in the band), so the gather stays
    shard-local; the PD stencil loop runs with 1-row halos per iteration.
    All collectives ride ICI.  Exact vs the unsharded solver while vertical
    displacements satisfy |v| <= max_disp - 2; larger motions sample the
    band edge (pick ``max_disp`` from the seed flow range; row
    displacements only — columns are unsharded).
    """
    from faldoi_tpu.ops.bicubic import bicubic_interp_at, bicubic_out_flag

    l_t = lambda_ * theta
    n_space = mesh.shape["space"]
    h, w = i0.shape
    assert h % n_space == 0, "H must divide the space axis"
    hs = h // n_space
    d = int(max_disp) + 2
    assert d <= hs, "halo band exceeds the shard height"

    from jax import shard_map

    def shard_fn(i0s, i1s, u1s, u2s):
        # centered gradient of the sharded frame: 1-row halos; the edge
        # shards' replicated rows reproduce mask.c's one-sided halves
        i1pad = _halo_exchange_rows(i1s, "space")
        pxc = jnp.concatenate([i1s[:, :1], i1s, i1s[:, -1:]], axis=1)
        i1xs = 0.5 * (pxc[:, 2:] - pxc[:, :-2])
        i1ys = 0.5 * (i1pad[2:, :] - i1pad[:-2, :])
        stack = jnp.stack([i1s, i1xs, i1ys], axis=-1)  # rows leading

        row0 = (jax.lax.axis_index("space") * hs).astype(jnp.float32)
        rr = jnp.arange(hs, dtype=jnp.float32)[:, None]
        cc = jnp.arange(w, dtype=jnp.float32)[None, :]

        def warp3(u1, u2):
            band = _halo_exchange_band(stack, d, "space")  # (hs+2d, w, 3)
            gx = cc + u1
            gy_band = rr + u2 + d           # band-local row coordinate
            gy_glob = row0 + rr + u2
            i1w, i1wx, i1wy = (
                bicubic_interp_at(band[..., k], gx, gy_band, False)
                for k in range(3)
            )
            out = bicubic_out_flag(h, w, gx, gy_glob)
            zero = jnp.zeros_like(i1w)
            return (jnp.where(out, zero, i1w), jnp.where(out, zero, i1wx),
                    jnp.where(out, zero, i1wy))

        u1c, u2c = u1s, u2s
        # duals persist ACROSS warps (tvl2OF takes xi from the caller and
        # never re-zeroes it inside the warp loop, global_faldoi.cpp:556-882)
        xi11 = jnp.zeros_like(u1c)
        xi12 = jnp.zeros_like(u1c)
        xi21 = jnp.zeros_like(u1c)
        xi22 = jnp.zeros_like(u1c)
        for _ in range(warps):
            i1ws, i1wxs, i1wys = warp3(u1c, u2c)
            grad, rho_c = warp_constants(i0s, i1ws, i1wxs, i1wys, u1c, u2c)

            def body(_, st):
                u1, u2, u1_, u2_, xi11, xi12, xi21, xi22 = st
                v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wxs, i1wys, grad,
                                        l_t)
                u1x, u1y = _fwd_grad_sharded(u1_, "space")
                u2x, u2y = _fwd_grad_sharded(u2_, "space")
                xi11, xi12, xi21, xi22 = tvl2_getD(
                    xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, tau
                )
                d1 = _divergence_sharded(xi11, xi12, "space")
                d2 = _divergence_sharded(xi21, xi22, "space")
                nu1, nu2, _ = tvl2_getP(u1, u2, v1, v2, d1, d2, theta, tau)
                return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2,
                        xi11, xi12, xi21, xi22)

            st = (u1c, u2c, u1c, u2c, xi11, xi12, xi21, xi22)
            st = jax.lax.fori_loop(0, iters, body, st)
            u1c, u2c = st[0], st[1]
            xi11, xi12, xi21, xi22 = st[4], st[5], st[6], st[7]
        return u1c, u2c

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(PS("space", None),) * 4,
        out_specs=(PS("space", None), PS("space", None)),
    )
    return jax.jit(sharded)(i0, i1, u1, u2)


def pipeline_train_step(mesh: Mesh, batch_i0, batch_i1, batch_seeds,
                        n_seeds: int = 64, bsz: int = 64, n_sweeps: int = 6,
                        wr: int = 5, fb_eps: float = 2.0,
                        glob_iters: int = 20):
    """One full REAL pipeline step over a 'data'-sharded batch of frame
    pairs, all under one jit over the mesh: seed insertion
    (``core.local_step.seed_batch``) -> wavefront growing (the production
    ``_sweep_body``) -> FB-consistency pruning + re-queueing
    (``core.pruning`` / ``core.match_growing`` machinery) -> final growing
    -> global TV-L1 PD refinement.  This is the multi-chip dryrun body —
    the actual pipeline kernels, bounded sweep/iteration counts."""
    from faldoi_tpu.core.functionals import make_solver_consts, solve_tvl1
    from faldoi_tpu.core.local_step import (
        _sweep_body, init_state, seed_batch,
    )
    from faldoi_tpu.core.match_growing import (
        _delete_untrusted, _insert_potential,
    )
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.core.pruning import fb_consistency_check
    from faldoi_tpu.ops import divergence, forward_gradient

    h, w = batch_i0.shape[1:]
    n = h * w
    p = 2 * wr + 1
    sal = jnp.ones((n + 1,), jnp.float32)
    ones_trust = jnp.ones((n + 1,), jnp.int32)

    def insert(state, seeds2d, sc):
        uu = seeds2d[..., 0].ravel()
        vv = seeds2d[..., 1].ravel()
        fin = jnp.isfinite(uu) & jnp.isfinite(vv)
        score, idx = jax.lax.top_k(fin.astype(jnp.float32), n_seeds)
        valid = score > 0.5
        su = jnp.where(valid, jnp.nan_to_num(uu[idx]), 0.0)
        sv = jnp.where(valid, jnp.nan_to_num(vv[idx]), 0.0)
        state = seed_batch(state, idx, su, sv, valid, solve_tvl1, sc, sal,
                           h, w, n_seeds, warps=1, max_iters=4)
        # re-fix seeds with original flow + zero energy (insert_seeds host
        # path, local_faldoi.cpp:785-795) — traced form with a dump slot
        idxs = jnp.where(valid, idx, n)
        return state._replace(
            fixed=state.fixed.at[idxs].set(True),
            out_u=state.out_u.at[idxs].set(su),
            out_v=state.out_v.at[idxs].set(sv),
            ene=state.ene.at[idxs].set(0.0),
            cand_e=state.cand_e.at[idxs].set(jnp.inf),
        )

    def grow(state, sc, trust, iteration):
        trust2d = trust[:n].reshape(h, w).astype(jnp.float32)

        def body(_, st):
            # the PRODUCTION growing config (match_growing defaults for
            # m0: patch fill with red-black relax, delta 0.05/rel 0.5,
            # queue-adaptive floor scale 64, dense-phase floor 4096)
            st, _acc = _sweep_body(
                st, solve_tvl1, sc, trust2d, sal,
                jnp.asarray(iteration, jnp.int32),
                h, w, wr, bsz, 1, 4, delta=0.05, delta_rel=0.5,
                fill="patch_rb", floor=4096, floor_scale=64, relax=False,
                with_chi=False,
            )
            return st

        return jax.lax.fori_loop(0, n_sweeps, body, state)

    def one(i0, i1, seeds_fwd):
        i0x, i0y = centered_gradient(i0)
        i1x, i1y = centered_gradient(i1)
        sc_go = make_solver_consts(
            0, pad_for_crops(i0, p), i1, i1x, i1y, 40.0, 0.3, 0.125, 0.01,
            wr=wr, p=p,
        )
        sc_ba = make_solver_consts(
            0, pad_for_crops(i1, p), i0, i0x, i0y, 40.0, 0.3, 0.125, 0.01,
            wr=wr, p=p,
        )
        # bwd seeds: negated fwd seeds (dryrun stand-in for the bwd matches)
        st_go = insert(init_state(h, w), seeds_fwd, sc_go)
        st_ba = insert(init_state(h, w), -seeds_fwd, sc_ba)
        st_go = grow(st_go, sc_go, ones_trust, 0)
        st_ba = grow(st_ba, sc_ba, ones_trust, 0)

        fwd_u = jnp.nan_to_num(st_go.out_u[:n].reshape(h, w))
        fwd_v = jnp.nan_to_num(st_go.out_v[:n].reshape(h, w))
        bwd_u = jnp.nan_to_num(st_ba.out_u[:n].reshape(h, w))
        bwd_v = jnp.nan_to_num(st_ba.out_v[:n].reshape(h, w))
        tg = fb_consistency_check(fwd_u, fwd_v, bwd_u, bwd_v, fb_eps)
        trust_go = jnp.concatenate([tg.ravel(), jnp.ones((1,), jnp.int32)])
        st_go = _insert_potential(
            _delete_untrusted(st_go, trust_go, n), n
        )
        st_go = grow(st_go, sc_go, trust_go, 1)

        # global TV-L1 PD refinement on the densified flow (one warp)
        u0 = jnp.nan_to_num(st_go.out_u[:n].reshape(h, w))
        v0 = jnp.nan_to_num(st_go.out_v[:n].reshape(h, w))
        l_t = 40.0 * 0.3
        i1w = bicubic_warp(i1, u0, v0, True)
        i1wx = bicubic_warp(i1x, u0, v0, True)
        i1wy = bicubic_warp(i1y, u0, v0, True)
        grad, rho_c = warp_constants(i0, i1w, i1wx, i1wy, u0, v0)
        xi = [jnp.zeros_like(u0) for _ in range(4)]

        def body(_, st):
            u1, u2, u1_, u2_, xi11, xi12, xi21, xi22 = st
            v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
            u1x, u1y = forward_gradient(u1_)
            u2x, u2y = forward_gradient(u2_)
            xi11, xi12, xi21, xi22 = tvl2_getD(
                xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, 0.125
            )
            d1 = divergence(xi11, xi12)
            d2 = divergence(xi21, xi22)
            nu1, nu2, _ = tvl2_getP(u1, u2, v1, v2, d1, d2, 0.3, 0.125)
            return (nu1, nu2, 2 * nu1 - u1, 2 * nu2 - u2,
                    xi11, xi12, xi21, xi22)

        st = (u0, v0, u0, v0, *xi)
        st = jax.lax.fori_loop(0, glob_iters, body, st)
        return jnp.stack([st[0], st[1]], axis=-1)

    sh = NamedSharding(mesh, PS("data"))
    batch_i0 = jax.device_put(batch_i0, sh)
    batch_i1 = jax.device_put(batch_i1, sh)
    batch_seeds = jax.device_put(batch_seeds, sh)
    fn = jax.jit(jax.vmap(one), in_shardings=(sh, sh, sh), out_shardings=sh)
    return fn(batch_i0, batch_i1, batch_seeds)

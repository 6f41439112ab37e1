"""Multi-chip spatial sharding of the LOCAL step (seed growing).

The reference partitions the local growing across OpenMP threads with
``-split_img`` (aux_partitions.cpp:47-270; one sub-image per thread, queues
rebinned between iterations, grid transposed every other iteration to avoid
seams).  The replacement here shards the growing STATE by rows over
the mesh's 'space' axis and keeps every sweep's semantics:

* each shard owns ``hs = h / n_space`` rows of every state plane and runs
  the production ``_sweep_body`` on an EXTENDED domain (its rows plus a
  ``halo``-row band ppermuted from the row neighbours each sweep), popping
  only candidates it owns (per-shard ``top_k`` of ``bsz / n_space``);
* the delta-band anchor is ``pmin``-ed across shards (``band_axis``), so
  acceptance follows the same GLOBAL energy order as the unsharded sweeps
  — unlike the reference's partitions, which drain queues independently;
* writes that land in the halo (candidate inserts and working-flow patch
  extents of centres within ``wr`` of a shard edge) are exported back to
  their owner after every sweep and merged with the same rules the
  unsharded scatters use: min-energy for candidates, max-energy-key for
  the working flow.  Donations cannot cross (a neighbour's stale view of
  our ``fixed`` plane gates them off) — they arrive one sweep later as
  ordinary candidate inserts, the only ordering relaxation vs unsharded.

Solver constants (the frames and their gradients) stay replicated: patch
warps sample I1 at patch+flow positions that can be anywhere in the image
(large displacements), exactly like the reference partitions share the
full image arrays across threads.  Compute and state bandwidth — the
actual scaling costs — are fully sharded; collectives are halo-sized and
ride ICI.

Production semantics (r4 — previously a correctness twin): chunked
dispatches with the adaptive per-shard rung ladder (max_acc protocol as
``LocalSolver.grow_pair``; accept rule rung-invariant via the pinned rank
floor), warm-band requeues between outer iterations
(FALDOI_GROW_WARM_BAND, default 10 as unsharded), the late-phase floor
scale, and the ordering dials (exactmin / defer / wscatter / the r4
kernel dials) threaded through — note exactmin windows and the defer
reduction remain SHARD-LOCAL approximations at shard boundaries
(local_step.py docstrings); equality vs unsharded is gated in
tests/test_parallel.py at space=2 and space=4 (production dials).
Drain programs are jit-cached per (rung, first_iter, floor-scale), not
re-traced per outer iteration.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from faldoi_tpu.core.local_step import GrowState, _sweep_body

# Module-level cache of jitted shard_map drain programs, keyed on every
# trace-affecting parameter (mesh, geometry, solver, dials, rung, ...).
# Hoisted out of spatial_match_growing: a per-call cache
# re-traced and re-jitted every (rung, fi, fs) variant on every call —
# ~half of the r4 multichip-dryrun timeout.  jax.jit's own dispatch cache
# is per-callable, so the callable itself must be reused across calls.
_DRAIN_CACHE: dict = {}


def _exchange_rows(x, d: int, axis_name: str, row_axis: int = 0):
    """Extend ``x`` by ``d`` rows from each row neighbour along
    ``row_axis``: (hs, ...) -> (d + hs + d, ...).  Global edge shards
    replicate their own edge row (the eligibility/bounds masks make those
    rows inert)."""
    if row_axis != 0:
        x = jnp.moveaxis(x, row_axis, 0)
    idx = jax.lax.axis_index(axis_name)
    ns = jax.lax.axis_size(axis_name)
    from_below = jax.lax.ppermute(
        x[:d], axis_name, [(i, (i - 1) % ns) for i in range(ns)]
    )
    from_above = jax.lax.ppermute(
        x[-d:], axis_name, [(i, (i + 1) % ns) for i in range(ns)]
    )
    rep_top = jnp.broadcast_to(x[:1], (d,) + x.shape[1:])
    rep_bot = jnp.broadcast_to(x[-1:], (d,) + x.shape[1:])
    top = jnp.where(idx == 0, rep_top, from_above)
    bot = jnp.where(idx == ns - 1, rep_bot, from_below)
    out = jnp.concatenate([top, x, bot], axis=0)
    if row_axis != 0:
        out = jnp.moveaxis(out, 0, row_axis)
    return out


def _send_up(x, axis_name):
    """Give each shard its BELOW neighbour's array (shard s receives from
    s+1); the last shard receives wrapped garbage — callers gate on idx."""
    ns = jax.lax.axis_size(axis_name)
    return jax.lax.ppermute(x, axis_name,
                            [(i, (i - 1) % ns) for i in range(ns)])


def _send_down(x, axis_name):
    ns = jax.lax.axis_size(axis_name)
    return jax.lax.ppermute(x, axis_name,
                            [(i, (i + 1) % ns) for i in range(ns)])


def drain_spatial(
    owned,                  # dict of 12 GrowState planes, each (L, hs, w)
    sconsts,                # SolverConsts stacked on leading L axis
    trust, sal,             # (L, hs, w) / (L, hs, w)
    iteration,
    solver, hs: int, h: int, w: int, wr: int, bsz: int,
    warps: int, max_iters: int,
    halo: int, axis_name: str = "space",
    max_sweeps: int = 10_000,
    delta: float = 0.05, fill: str = "patch_rb", floor=None,
    relax: bool = False, relax_margin: float = 0.95, delta_rel: float = 0.5,
    floor_scale: int = 64, with_chi: bool = True, first_iter: bool = False,
    dials=None,
):
    """Drain all L direction lanes' queues, rows sharded over ``axis_name``.

    Runs INSIDE shard_map.  Returns (planes, sweeps, max_acc) — ``max_acc``
    is the largest single-sweep GLOBAL acceptance within this dispatch, the
    caller's adaptive-rung signal (same protocol as LocalSolver.grow_pair;
    ``max_sweeps`` doubles as the chunk bound)."""
    assert halo >= wr + 1, "halo must cover patch reach"
    he = hs + 2 * halo
    ne = he * w
    sidx = jax.lax.axis_index(axis_name)
    ns = jax.lax.axis_size(axis_name)
    row0 = sidx * hs                       # first owned global row
    roff = row0 - halo                     # ext row -> global row offset
    # true-image bounds in ext coords: only the global border clamps
    ymin = jnp.where(sidx == 0, halo, 0)
    ymax = jnp.where(sidx == ns - 1, halo + hs, he)

    rr = jnp.arange(he)
    owned_rows = (rr >= halo) & (rr < halo + hs)
    owned_mask = jnp.concatenate(
        [jnp.repeat(owned_rows, w), jnp.zeros((1,), bool)]
    )

    L = trust.shape[0]
    trust_ext = _exchange_rows(trust, halo, axis_name, row_axis=1)
    sal_ext = _exchange_rows(sal, halo, axis_name, row_axis=1)
    sal_flat = jnp.concatenate(
        [sal_ext.reshape(L, ne), jnp.ones((L, 1), sal_ext.dtype)], axis=1
    )

    pads = {"fixed": False, "out_u": jnp.nan, "out_v": jnp.nan,
            "ene": jnp.inf, "cand_u": 0.0, "cand_v": 0.0, "cand_e": jnp.inf,
            "wu": jnp.nan, "wv": jnp.nan, "out_chi": 0.0, "cand_chi": 0.0,
            "wchi": 0.0}
    names = list(GrowState._fields)

    def to_ext_state(planes):
        flat = {}
        for k in names:
            ext = _exchange_rows(planes[k], halo, axis_name, row_axis=1)
            pad = jnp.full((L, 1), pads[k], ext.dtype)
            flat[k] = jnp.concatenate([ext.reshape(L, ne), pad], axis=1)
        return GrowState(**flat)

    def sweep_once(planes):
        st = to_ext_state(planes)

        def one_lane(s, sc, tr, sl):
            return _sweep_body(
                s, solver, sc, tr, sl, iteration,
                he, w, wr, bsz, warps, max_iters,
                delta=delta, fill=fill, floor=floor, relax=relax,
                relax_margin=relax_margin, delta_rel=delta_rel,
                floor_scale=floor_scale,
                owned=owned_mask, ybounds=(ymin, ymax), row_offset=roff,
                band_axis=axis_name, with_wkey=True, with_chi=with_chi,
                first_iter=first_iter, dials=dials,
            )

        # unrolled lanes, not vmap (lane-vmap measures ~4x a single
        # lane; see local_step.grow_chunk_pair)
        tr_f = trust_ext.astype(jnp.float32)
        sts, accs, wkeys = [], [], []
        for lane in range(L):
            s_l = jax.tree.map(lambda a: a[lane], st)
            sc_l = jax.tree.map(lambda a: a[lane], sconsts)
            s_l, acc_l, wk_l = one_lane(s_l, sc_l, tr_f[lane], sal_flat[lane])
            sts.append(s_l)
            accs.append(acc_l)
            wkeys.append(wk_l)
        st2 = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
        acc = jnp.stack(accs)
        wkey = jnp.stack(wkeys)
        acc_tot = jax.lax.psum(acc.sum(), axis_name)

        ext2d = {k: getattr(st2, k)[:, :ne].reshape(L, he, w) for k in names}
        wkey2d = wkey[:, :ne].reshape(L, he, w)

        # --- merge halo writes back into their owners -------------------
        # neighbour s+1's TOP halo strip targets my owned rows [hs-halo, hs)
        # neighbour s-1's BOTTOM halo strip targets my owned rows [0, halo)
        def strips(x):
            return (_send_up(x[:, :halo], axis_name),
                    _send_down(x[:, -halo:], axis_name))

        have_below = sidx < ns - 1
        have_above = sidx > 0

        cand_keys = ("cand_e", "cand_u", "cand_v", "cand_chi")
        w_keys = ("wu", "wv", "wchi")

        exp = {k: strips(ext2d[k]) for k in cand_keys + w_keys}
        ktop, kbot = strips(wkey2d)

        new_planes = {}
        for k in names:
            new_planes[k] = ext2d[k][:, halo:halo + hs]

        # candidate merges: min cand_e wins
        for region, side, gate in ((slice(hs - halo, hs), 0, have_below),
                                   (slice(0, halo), 1, have_above)):
            win = gate & (exp["cand_e"][side]
                          < new_planes["cand_e"][:, region])
            for k in cand_keys:
                cur = new_planes[k][:, region]
                new_planes[k] = new_planes[k].at[:, region].set(
                    jnp.where(win, exp[k][side], cur)
                )

        # working-flow merges: max wkey wins (same rule as the unsharded
        # per-sweep scatter; my own wkey rows are the comparison targets)
        my_top = wkey2d[:, halo:2 * halo]                 # owned [0, halo)
        my_bot = wkey2d[:, hs:hs + halo]                  # owned [hs-halo, hs)
        for region, side, gate, mine in (
            (slice(hs - halo, hs), 0, have_below, my_bot),
            (slice(0, halo), 1, have_above, my_top),
        ):
            win = gate & (([ktop, kbot][side]) > mine)
            for k in w_keys:
                cur = new_planes[k][:, region]
                new_planes[k] = new_planes[k].at[:, region].set(
                    jnp.where(win, exp[k][side], cur)
                )
        return new_planes, acc_tot

    def cond(carry):
        _, acc, _mx, k = carry
        return jnp.logical_and(acc > 0, k < max_sweeps)

    def body(carry):
        planes, _, mx, k = carry
        planes, acc = sweep_once(planes)
        return planes, acc, jnp.maximum(mx, acc), k + 1

    carry = (owned, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32))
    owned, _, mx, k = jax.lax.while_loop(cond, body, carry)
    return owned, k, mx


def spatial_match_growing(
    mesh: Mesh,
    go: np.ndarray, ba: np.ndarray,
    i0n, i1n, prm,
    bsz: int = 8192, halo: int = 8,
    delta: float = 0.05, fill: str = "patch", relax: bool = False,
    delta_rel: float = 0.5, floor_scale: int = 64,
    verbose: bool = False,
):
    """``match_growing`` with the growing state and sweeps row-sharded over
    the mesh's 'space' axis — the multi-chip local step (reference
    counterpart: ``-split_img``, local_faldoi.cpp:1304-1384).

    Seed insertion runs unsharded (one cheap batched solve), the iterated
    drains run sharded, FB pruning runs on gathered flows (4 whole-image
    stencil passes per outer iteration — negligible next to the sweeps).
    Returns (flow, energy, occ) for the forward direction like
    match_growing."""
    from faldoi_tpu.core.local_step import (
        LocalSolver, init_state, ordering_dials,
    )
    from faldoi_tpu.core.functionals import SOLVERS, make_solver_consts
    from faldoi_tpu.core.match_growing import (
        _delete_untrusted, _insert_potential, _warm_requeue,
    )
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.core.pruning import prune
    from faldoi_tpu.models import method_local_params
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu import params as P
    from jax import shard_map

    if fill == "patch" and prm.val_method not in (
        P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W
    ):
        fill = "patch_rb"
    h, w = i0n.shape
    n = h * w
    ns = mesh.shape["space"]
    assert h % ns == 0, "H must divide the space axis"
    hs = h // ns
    assert halo >= prm.w_radio + 1 and halo <= hs
    lam, theta, tau = method_local_params(prm.val_method, prm.w_radio)
    p = 2 * prm.w_radio + 1
    solver = SOLVERS[prm.val_method]
    with_chi = prm.val_method == P.M_TVL1_OCC

    i0x, i0y = centered_gradient(i0n)
    i1x, i1y = centered_gradient(i1n)
    sc_go = make_solver_consts(prm.val_method, pad_for_crops(i0n, p), i1n,
                               i1x, i1y, lam, theta, tau, prm.tol_OF,
                               wr=prm.w_radio, p=p)
    sc_ba = make_solver_consts(prm.val_method, pad_for_crops(i1n, p), i0n,
                               i0x, i0y, lam, theta, tau, prm.tol_OF,
                               wr=prm.w_radio, p=p)
    sc2 = jax.tree.map(lambda a, b: jnp.stack([a, b]), sc_go, sc_ba)

    sal = jnp.ones((n + 1,), jnp.float32)
    ls = LocalSolver(h, w, wr=prm.w_radio, bsz=min(bsz, n), solver=solver,
                     warps=prm.warps, max_iters=max(prm.max_iter_patch, 1),
                     mode="step", with_chi=with_chi)
    st_go = ls.insert_seeds(init_state(h, w), go, sc_go, sal)
    st_ba = ls.insert_seeds(init_state(h, w), ba, sc_ba, sal)
    st2 = jax.tree.map(lambda a, b: jnp.stack([a, b]), st_go, st_ba)

    bsz_shard = max(256, min(bsz, n) // ns)
    names = list(GrowState._fields)

    def to_planes(st):  # (2, n+1) flat -> dict of (2, h, w)
        return {k: getattr(st, k)[:, :n].reshape(2, h, w) for k in names}

    def from_planes(planes):  # dict of (2, h, w) -> (2, n+1) flat
        pads = {"fixed": False, "out_u": jnp.nan, "out_v": jnp.nan,
                "ene": jnp.inf, "cand_u": 0.0, "cand_v": 0.0,
                "cand_e": jnp.inf, "wu": jnp.nan, "wv": jnp.nan,
                "out_chi": 0.0, "cand_chi": 0.0, "wchi": 0.0}
        flat = {}
        for k in names:
            x = planes[k].reshape(2, n)
            flat[k] = jnp.concatenate(
                [x, jnp.full((2, 1), pads[k], x.dtype)], axis=1)
        return GrowState(**flat)

    plane_spec = {k: PS(None, "space", None) for k in names}
    dials = ordering_dials()
    import os as _os

    # PRODUCTION DRAIN SEMANTICS (mirrors LocalSolver.grow_pair):
    # * chunked dispatches — each jitted shard_map program runs up to
    #   ``chunk`` sweeps on-device and reports (sweeps, max_acc);
    # * adaptive rung ladder over the PER-SHARD batch (the accept rule is
    #   rung-invariant: the rank floor is pinned to the nominal
    #   bsz_shard//16, so smaller rungs only truncate top-k harder);
    # * programs live in the MODULE-level _DRAIN_CACHE keyed on every
    #   trace-affecting parameter, so they are traced once per variant and
    #   reused across chunks, outer iterations AND spatial_match_growing
    #   calls (a per-call cache re-traced everything each call).
    chunk = int(_os.environ.get("FALDOI_GROW_CHUNK", "16"))
    floor_pin = bsz_shard if relax else max(1, bsz_shard // 16)
    fs_late = int(_os.environ.get("FALDOI_GROW_FS_LATE", "0")) or min(
        floor_scale, 16)
    warm_band = int(_os.environ.get("FALDOI_GROW_WARM_BAND", "10"))
    # FALDOI_GROW_LEAN=0 disables the first_iter crop specialisation so the
    # it-0 and later drains share ONE program per (rung, fs) — halves the
    # compile load (values identical; lean is a dead-channel optimisation)
    lean = _os.environ.get("FALDOI_GROW_LEAN", "1") == "1"
    max_it = max(prm.max_iter_patch, 1)

    key_base = (mesh, solver, hs, h, w, prm.w_radio, prm.warps, max_it,
                halo, chunk, delta, fill, floor_pin, relax, delta_rel,
                with_chi, dials)

    def drain_chunk(planes, sc2_, trust2d, sal2d, it, *, rung, fi, fs):
        key = key_base + (rung, fi, fs)
        if key not in _DRAIN_CACHE:
            sharded = shard_map(
                lambda pl_, sc_, tr_, sl_, it_: drain_spatial(
                    pl_, sc_, tr_, sl_, it_,
                    solver, hs, h, w, prm.w_radio, rung,
                    prm.warps, max_it, halo, "space",
                    max_sweeps=chunk,
                    delta=delta, fill=fill, floor=floor_pin, relax=relax,
                    delta_rel=delta_rel, floor_scale=fs, with_chi=with_chi,
                    first_iter=fi, dials=dials,
                ),
                mesh=mesh,
                in_specs=(plane_spec, jax.tree.map(lambda _: PS(), sc2),
                          PS(None, "space", None), PS(None, "space", None),
                          PS()),
                out_specs=(plane_spec, PS(), PS()),
                check_vma=False,
            )
            _DRAIN_CACHE[key] = jax.jit(sharded)
        return _DRAIN_CACHE[key](planes, sc2_, trust2d, sal2d, it)

    ladder = tuple(b for b in (256, 512, 1024, 2048, 4096) if b < bsz_shard)
    ladder = ladder + (bsz_shard,)

    def drain(st2_, trust2d_, sal2d_, it, fs):
        """Host loop: chunked dispatches with sync rung adaptation."""
        planes = to_planes(st2_)
        cur = ladder[min(1, len(ladder) - 1)]
        fi = lean and isinstance(it, int) and it == 0
        it_j = jnp.asarray(it, jnp.int32)
        total = 0
        for _ in range(10_000):
            planes, k, mx = drain_chunk(planes, sc2, trust2d_, sal2d_, it_j,
                                        rung=cur, fi=fi, fs=fs)
            total += int(k)
            if int(k) < chunk:
                break
            m = int(mx)
            if m >= cur and cur < ladder[-1]:
                cur = ladder[min(ladder.index(cur) + 1, len(ladder) - 1)]
            elif m < cur // 3 and cur > ladder[0]:
                cur = next((b for b in ladder if b >= m + m // 2),
                           ladder[-1])
        return from_planes(planes), total

    sal2d = jnp.ones((2, h, w), jnp.float32)
    trust2d = jnp.ones((2, h, w), jnp.int32)
    import time
    for it in range(prm.iterations_of):
        t0 = time.time()
        st2, k = drain(st2, trust2d, sal2d, it,
                       floor_scale if it == 0 else fs_late)
        if verbose:
            jax.block_until_ready(st2)
            print(f"(spatial_growing) it={it}: {k} sweeps "
                  f"{time.time() - t0:.2f}s")
        fwd = jnp.stack([st2.out_u[0, :n].reshape(h, w),
                         st2.out_v[0, :n].reshape(h, w)], axis=-1)
        bwd = jnp.stack([st2.out_u[1, :n].reshape(h, w),
                         st2.out_v[1, :n].reshape(h, w)], axis=-1)
        tg, tb = prune(i0n, i1n, fwd, bwd, prm.epsilon)
        trust2d = jnp.stack([tg, tb])
        trust2 = jnp.concatenate(
            [trust2d.reshape(2, n), jnp.ones((2, 1), jnp.int32)], axis=1)
        if warm_band:
            # warm drains (production default, as match_growing): re-queue
            # only a band around pruned holes, keep the far field fixed
            st2 = _warm_requeue(st2, trust2, n, h, w, warm_band)
        else:
            st2 = _insert_potential(_delete_untrusted(st2, trust2, n), n)

    st2, k = drain(st2, trust2d, sal2d, prm.iterations_of, fs_late)
    flow = np.stack([np.asarray(st2.out_u[0, :n]).reshape(h, w),
                     np.asarray(st2.out_v[0, :n]).reshape(h, w)], axis=-1)
    ene = np.asarray(st2.ene[0, :n]).reshape(h, w)
    occ = np.asarray(st2.out_chi[0, :n]).reshape(h, w)
    return flow, ene, occ

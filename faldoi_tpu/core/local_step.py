"""Local step — energy-guided seed growing as batched wavefront sweeps.

The reference (``local_faldoi.cpp:891-1039``) grows flow from sparse seeds
with a serial priority queue: pop the lowest-energy candidate, fix it, run an
11x11 patch primal-dual solve, push its 4-neighbours.  That ordering
heuristic is inherently sequential (~450k pops, each a scalar patch solve).

Re-design: **batched best-first wavefront sweeps**.  Per sweep we pop the
``B`` lowest-energy candidates at once (a ``top_k`` over the candidate
field), fix them, solve all their patches in one fused, vmapped batch, and
scatter the results (min-energy wins for candidate updates, max-energy wins
for working-flow overlaps, matching the pop order's later-overwrites
behaviour).  ``B`` interpolates between the exact serial order (B=1) and a
fully parallel flood (B=inf); the FB-consistency pruning plus the 3 outer
iterations make the result robust to this reordering (validated against the
reference binary's output on the golden examples).

The whole growing runs as ONE device program: a ``lax.while_loop`` over
sweeps (every sweep is shape-static; patch crops are ``dynamic_slice``s from
edge-padded planes, scatters go through a dump slot).

State layout: flat (h*w+1,) arrays — the extra slot is a scatter dump for
masked lanes.

Reference-semantics notes:
* seed insertion (``insert_initial_seeds``, :748-796) runs 3x3 solves
  (w_radio forced to 1) around each seed with *only that seed* fixed, pushes
  4-neighbour candidates, then re-fixes seeds with their original flow and
  energy 0 — we batch all seeds at once; patches see only their own centre
  as data because the fill initialises from the centre alone.
* ``add_neighbors`` (:679-727) re-initialises the patch by Poisson fill from
  fixed pixels on iteration 0, and on later iterations only when the patch
  contains pruned pixels; otherwise the persistent working flow is the init.
* the candidate energy stored/compared is the patch-mean energy x saliency
  (``insert_candidates``, :497-537; saliency defaults to 1).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from faldoi_tpu.ops.poisson import poisson_fill_canvas
from faldoi_tpu.core.patch_solver import crop_padded, pad_for_crops
from faldoi_tpu.core.functionals import SolverConsts, solve_tvl1
from faldoi_tpu.ops.stencils import _rowcol_ids


class GrowState(NamedTuple):
    fixed: jnp.ndarray   # (N+1,) bool
    out_u: jnp.ndarray   # (N+1,)
    out_v: jnp.ndarray
    ene: jnp.ndarray     # (N+1,) best energy at fixed pixels
    cand_u: jnp.ndarray  # (N+1,) best queued candidate
    cand_v: jnp.ndarray
    cand_e: jnp.ndarray  # inf = no candidate
    wu: jnp.ndarray      # (N+1,) persistent working flow (ofD->u1/u2)
    wv: jnp.ndarray
    out_chi: jnp.ndarray  # (N+1,) occlusion output (method 8; 0 otherwise)
    cand_chi: jnp.ndarray
    wchi: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("h", "w"))
def init_state(h: int, w: int) -> GrowState:
    n = h * w + 1
    z = jnp.zeros((n,), jnp.float32)
    return GrowState(
        fixed=jnp.zeros((n,), bool),
        out_u=jnp.full((n,), jnp.nan, jnp.float32),
        out_v=jnp.full((n,), jnp.nan, jnp.float32),
        ene=jnp.full((n,), jnp.inf, jnp.float32),
        cand_u=z,
        cand_v=z,
        cand_e=jnp.full((n,), jnp.inf, jnp.float32),
        wu=jnp.full((n,), jnp.nan, jnp.float32),
        wv=jnp.full((n,), jnp.nan, jnp.float32),
        out_chi=z,
        cand_chi=z,
        wchi=z,
    )


# Sort-key bias making re-claims rank after all frontier candidates in the
# top-k cut (energies are patch means of O(1) quantities; 1e6 dominates).
RECLAIM_BIAS = 1.0e6


def ordering_dials():
    """Snapshot the trace-time ordering-dial env knobs as a hashable tuple.

    These knobs are baked into the sweep program at trace time; passing the
    tuple as a STATIC jit argument makes an in-process env change retrace
    instead of silently reusing a program compiled under the old values
    (measured: FALDOI_GROW_EXACTMIN flipped mid-process produced
    bit-identical outputs to the cached no-exactmin program)."""
    exactmin = int(os.environ.get("FALDOI_GROW_EXACTMIN", "0") or 0)
    # Working-flow scatter radius (5 = full 11x11 patch, the reference
    # semantics; smaller radii cut the dominant scatter's update count
    # (2r+1)^2/121-fold at an init-staleness cost)
    wscatter_r = int(os.environ.get("FALDOI_WSCATTER_R", "3") or 3)
    if exactmin > 0:
        # the window-min commutation proof (see _sweep_body) REQUIRES the
        # full-patch working-flow scatter: pin it so FALDOI_GROW_EXACTMIN
        # is self-consistent
        wscatter_r = 5
    return (
        exactmin,
        os.environ.get("FALDOI_GROW_EXACTMIN_BAND", "0"),
        float(os.environ.get("FALDOI_GROW_DEFER", "0") or 0),
        int(os.environ.get("FALDOI_GROW_DEFER_WIN", "0") or 0),
        os.environ.get("FALDOI_WSCATTER", "approx"),
        os.environ.get("FALDOI_ABLATE", ""),
        wscatter_r,
    )


def _lean_enabled() -> bool:
    """FALDOI_GROW_LEAN=0 disables the first_iter crop specialisation so
    iteration-0 and later drains share one program per rung — halves the
    big-program compile load of a cold process (values identical: lean only
    drops channels the it-0 sweep never reads)."""
    return os.environ.get("FALDOI_GROW_LEAN", "1") == "1"


def _patch_geometry(idx, h, w, wr, ymin=0, ymax=None):
    """get_index_patch (utils.cpp:36-54) for flat indices.

    ``ymin``/``ymax`` clamp the patch box vertically — the spatially-sharded
    growing passes the shard's global-image bounds in extended-domain
    coordinates so interior shard edges do NOT clamp (only the true image
    border does)."""
    if ymax is None:
        ymax = h
    i = idx % w
    j = idx // w
    oy = jnp.maximum(j - wr, ymin)
    ox = jnp.maximum(i - wr, 0)
    ph = jnp.minimum(j + 1 + wr, ymax) - oy
    pw = jnp.minimum(i + 1 + wr, w) - ox
    return i, j, oy, ox, ph, pw


def _scatter_min_payload(tgt_e, tgt_u, tgt_v, tgt_c, q, e, u, v, c, ok, dump):
    """Scatter (e,u,v[,chi]) to positions q where ok, keeping per-slot
    minimum e.  Ties may write either payload (equal-energy payloads
    equivalent).  ``tgt_c``/``c`` may be None (chi skipped: it is
    identically 0 for all non-occlusion methods)."""
    qs = jnp.where(ok, q, dump)
    e_masked = jnp.where(ok, e, jnp.inf)
    tgt_e = tgt_e.at[qs].min(e_masked)
    winner = ok & (e_masked <= tgt_e[qs])
    qw = jnp.where(winner, q, dump)
    tgt_u = tgt_u.at[qw].set(u)
    tgt_v = tgt_v.at[qw].set(v)
    if tgt_c is not None:
        tgt_c = tgt_c.at[qw].set(c)
    return tgt_e, tgt_u, tgt_v, tgt_c


def _scatter_max_payload(key_buf, tgt_u, tgt_v, tgt_c, q, key, u, v, c, ok,
                         dump, exact=None):
    """Scatter (u,v[,chi]) to q where ok, keeping payload of the maximum
    key.  Also returns the accumulated key plane (cross-shard merges need
    it).  ``tgt_c``/``c`` may be None (see _scatter_min_payload).

    ``exact=False`` skips the max-key winner resolution (one scatter-max +
    one gather over every patch cell): intra-sweep collisions then resolve
    in XLA's unspecified scatter order (on the GPU not even run-to-run
    deterministic) instead of by max energy.  Only valid for the
    working-flow plane (an init heuristic — colliding writes within one
    delta band are near-ties), never for the candidate/output
    min-scatters.  FALDOI_WSCATTER=exact restores the
    max-key rule; cross-shard merges always use exact (they need key_buf)."""
    if exact is None:
        exact = os.environ.get("FALDOI_WSCATTER", "approx") == "exact"
    if not exact:
        qw = jnp.where(ok, q, dump)
        tgt_u = tgt_u.at[qw].set(u)
        tgt_v = tgt_v.at[qw].set(v)
        if tgt_c is not None:
            tgt_c = tgt_c.at[qw].set(c)
        return key_buf, tgt_u, tgt_v, tgt_c
    qs = jnp.where(ok, q, dump)
    k_masked = jnp.where(ok, key, -jnp.inf)
    key_buf = key_buf.at[qs].max(k_masked)
    winner = ok & (k_masked >= key_buf[qs])
    qw = jnp.where(winner, q, dump)
    tgt_u = tgt_u.at[qw].set(u)
    tgt_v = tgt_v.at[qw].set(v)
    if tgt_c is not None:
        tgt_c = tgt_c.at[qw].set(c)
    return key_buf, tgt_u, tgt_v, tgt_c


def select_candidates(eligible, bsz):
    """The sweep's candidate selection: the ``bsz`` lowest ``eligible``
    energies (inf = not eligible) in ascending order, with their flat
    indices.  An exact ``lax.top_k``."""
    neg_e, idx = jax.lax.top_k(-eligible, bsz)
    return -neg_e, idx


def _dense_fill(fixed2d, out2d, iters=0):
    """Whole-image fill from fixed pixels — the dense alternative to the
    per-patch Poisson fill.  One fill per sweep shared by every patch (the
    per-patch multigrid, vmapped over thousands of patches, dominates the
    XLA program size and compile time).

    Nearest-front extension (jump-flood Voronoi + pinned relaxation, see
    ``ops.poisson.nearest_fill_image``): each unfixed cell continues its
    CLOSEST front's flow, which is what the reference's per-patch
    ``interpolate_poisson`` effectively computes at a frontier patch (it
    sees only the in-patch fixed pixels, i.e. the local front).  Two
    earlier dense variants measurably broke sparse-seed parity: a
    bounded-radius diffusion left zero-init cells beyond its reach, and a
    global harmonic fill interpolated BETWEEN distant fronts, biasing every
    frontier patch's init toward the opposing front (the 4-iteration PD
    solve never escapes a bad init, and init error compounds along growth
    chains)."""
    from faldoi_tpu.ops.poisson import nearest_fill_image

    x = jnp.where(fixed2d, out2d, jnp.nan)
    return nearest_fill_image(x)


def _sweep_body(
    state: GrowState,
    solver, sconsts, trust2d, sal, iteration,
    h, w, wr, bsz, warps, max_iters,
    delta=jnp.inf, fill="patch", floor=None, relax=True,
    relax_margin=0.95, delta_rel=0.0, floor_scale=0, block=0,
    floor_scale_hi=0, queue_hi=1 << 30,
    owned=None, ybounds=None, row_offset=None, band_axis=None,
    with_wkey=False, with_chi=True, first_iter=False, dials=None,
):
    """One wavefront sweep. Returns (state, n_accepted).

    ``first_iter`` (static) specialises the iteration-0 sweep: every patch
    init uses the Poisson fill (use_fill is unconditionally true when
    ``iteration == 0``), so the working-flow/trust crop channels are dead —
    a 3-channel crop instead of 6 (the vmapped dynamic_slice crop is the
    third-largest per-sweep cost).  Values identical to the generic path.

    Spatial-sharding hooks (all default-off; see parallel/spatial_grow):
    ``owned`` masks eligibility to the shard's own rows, ``ybounds`` clamps
    patch boxes / neighbour inserts at the true image border instead of the
    extended-domain edge, ``row_offset`` translates extended-domain rows to
    global rows for the solver's image-plane reads, ``band_axis`` pmins the
    delta-band anchor across shards (preserving the GLOBAL acceptance
    order), ``with_wkey`` additionally returns the working-flow scatter key
    plane so cross-shard overlaps merge with the same max-energy rule.

    ``delta`` is the Delta-stepping band: only candidates within ``delta`` of
    the sweep's minimum energy are accepted (plus the top-bsz cut).  A tight
    band tracks the reference's strict priority order more closely at the
    cost of more sweeps; inf = pure top-k batching.  ``floor`` (default
    bsz//16) guarantees a minimum acceptance per sweep regardless of the
    band — it bounds the sweep count at n/floor; floor=bsz accepts the whole
    top-k batch (every solved patch is used, no throttling).
    """
    n = h * w
    dump = n
    p = 2 * wr + 1

    # Ordering dials (exactmin / defer / wscatter / ablate) are STATIC
    # program structure; jitted callers pass ``dials`` (ordering_dials())
    # through their static args so env changes retrace.  Direct callers
    # (drain_spatial re-traces every call) may omit it.
    if dials is None:
        dials = ordering_dials()
    # measurement-only ablations: FALDOI_ABLATE=nofill|nosolve|nowscatter —
    # cuts that phase out of the program (XLA DCEs the dead chain) so its
    # true in-program cost can be measured by difference. NEVER in production.
    _ablate = dials[5]

    if relax:
        # LABEL-CORRECTING RELAXATION (Bellman-Ford where the reference's
        # heap is Dijkstra): every front advances every sweep, and a FIXED
        # pixel is re-popped when a strictly lower-energy claim arrives
        # (relative margin bounds the tail).  The serial pop order is an
        # arbitration rule between competing fronts — "lowest energy claim
        # wins"; relaxation converges to that same winner without the
        # global ordering, so the sweep count tracks the frontier advance
        # (~distance-to-seed) instead of n/batch.
        improving = state.cand_e[:n] < state.ene[:n] * relax_margin - 1e-6
        # frontier-first: unfixed candidates (true new ground) outrank
        # re-claims in the top-k cut, so improvement churn never starves
        # the advancing front
        key = jnp.where(state.fixed[:n], state.cand_e[:n] + RECLAIM_BIAS,
                        state.cand_e[:n])
        eligible = jnp.where(improving, key, jnp.inf)
    else:
        eligible = jnp.where(state.fixed[:n], jnp.inf, state.cand_e[:n])
    if owned is not None:
        eligible = jnp.where(owned[:n], eligible, jnp.inf)
    e_pop, idx = select_candidates(eligible, bsz)
    valid = jnp.isfinite(e_pop)
    # GLOBAL delta band: accept candidates within ``delta`` of the sweep's
    # minimum eligible energy (the parity-validated approximation of the
    # serial heap's strict order), plus a rank floor that bounds the sweep
    # count (top_k output is sorted, so the first ranks ARE the lowest
    # energies).
    if floor is None:
        floor = bsz // 16
    rank = jnp.arange(bsz)
    e_min = e_pop[0]
    if band_axis is not None:
        # anchor the band at the GLOBAL minimum eligible energy so the
        # sharded acceptance tracks the same serial order as unsharded
        e_min = jax.lax.pmin(e_min, band_axis)
    # the acceptance band: absolute delta near zero energy, relative
    # (delta_rel * e_min) once energies grow — the serial heap's order
    # matters most between LOW-energy fronts (they decide who claims
    # territory); between high-energy stragglers the precision is wasted
    # sweeps, so the band widens proportionally.
    band = e_min + jnp.maximum(jnp.float32(delta), delta_rel * e_min)
    if block:
        # BLOCK-LOCAL bands: the serial heap's global order only has
        # consequences where fronts COMPETE — within a neighbourhood.  Far
        # apart fronts can advance concurrently without changing who wins
        # any pixel, so each (block x block) tile gets its own delta band
        # anchored at the tile's minimum eligible energy.  Acceptance per
        # sweep then scales with the number of active tiles instead of the
        # global band occupancy.
        by = -(-h // block)
        bx = -(-w // block)
        e2d = jnp.pad(
            eligible.reshape(h, w),
            ((0, by * block - h), (0, bx * block - w)),
            constant_values=jnp.inf,
        )
        bmin = e2d.reshape(by, block, bx, block).min(axis=(1, 3))
        bmin_f = jnp.repeat(jnp.repeat(bmin, block, 0), block, 1)[:h, :w]
        bband = bmin_f + jnp.maximum(jnp.float32(delta),
                                     delta_rel * bmin_f)
        in_local = eligible <= bband.reshape(n)
        # a candidate passes with EITHER its local band or the global one
        local_at = jnp.concatenate([in_local, jnp.zeros((1,), bool)])[idx]
        e_ok = (e_pop <= band) | local_at
    else:
        e_ok = e_pop <= band
    # queue-adaptive floor: the rank floor exists to bound the sweep count
    # when the queue is LARGE (dense growth phase, where band occupancy is
    # high and intra-band order is noise).  When the queue is SMALL — a few
    # sparse fronts racing across seed-poor terrain — rank-floor acceptance
    # is breadth-first flooding and destroys the serial pop order exactly
    # where it decides the result (measured: rg 2.69 px vs the reference on
    # a sparse 192x256 crop).  Scale the floor with the queue so sparse
    # phases degrade to (near-)serial delta-band acceptance.
    queue = jnp.isfinite(eligible).sum()
    floor_base = jnp.maximum(jnp.asarray(floor, jnp.int32), 1)
    # staged throttle: rank-floor flooding only destroys the serial order
    # when the queue is a handful of racing fronts (the r2 sparse-crop
    # failure); once the frontier is LARGE, many independent fronts are
    # active and a looser scale is safe (measured: floor=4096 in dense
    # phases keeps var EPE at 0.0272).  queue >= queue_hi switches the
    # divisor from floor_scale to floor_scale_hi.
    fs_lo = jnp.maximum(jnp.asarray(floor_scale, jnp.int32), 1)
    fs_hi = jnp.asarray(floor_scale_hi, jnp.int32)
    q_hi = jnp.asarray(queue_hi, jnp.int32)
    fscale = jnp.where((fs_hi > 0) & (queue >= q_hi), fs_hi, fs_lo)
    floor_dyn = jnp.where(
        fscale > 1,
        jnp.minimum(floor_base, jnp.maximum(1, queue // fscale)),
        floor_base,
    )
    valid = valid & (e_ok | (rank < floor_dyn))

    # EXACT WINDOW-MIN acceptance (FALDOI_GROW_EXACTMIN=<win px>, 0=off):
    # the strictest order-commutation rule — accept ONLY candidates that are
    # the minimum eligible energy within their (win x win) interaction
    # window.  A pop's side effects (fixed flag, working-flow scatter over
    # the patch extent, neighbour candidate inserts) reach at most
    # 2*wr+1 px, so with win >= 4*wr+3 two same-sweep accepts provably
    # cannot see each other's writes and the sweep is order-equivalent to
    # the serial heap popping each accepted candidate before any eligible
    # candidate in its window (cascaded inserts from outside the window are
    # the only approximation).  Replaces the band/floor throttles when on.
    # Measurement knob for the ordering frontier (PARITY.md deviation #1).
    _exact = dials[0]
    if _exact > 0:
        el2 = eligible.reshape(h, w)
        r_ = jax.lax.reduce_window(el2, jnp.inf, jax.lax.min,
                                   (1, _exact), (1, 1), "SAME")
        wmin2 = jax.lax.reduce_window(r_, jnp.inf, jax.lax.min,
                                      (_exact, 1), (1, 1), "SAME").reshape(n)
        is_min = eligible <= wmin2
        min_at = jnp.concatenate([is_min, jnp.zeros((1,), bool)])[idx]
        valid = jnp.isfinite(e_pop) & min_at
        _emb = dials[1]
        if _emb == "1":
            # ALSO require the GLOBAL delta band (no rank floor): window
            # minima outside the band wait for the globally-lower fronts —
            # the serial heap's cross-region arbitration.  Progress is
            # still guaranteed: the global minimum is always a window
            # minimum and always in band.  Best parity measured (rg
            # 0.1297) but near-serial sparse phases (~29 min full-scale).
            valid = valid & e_ok
        elif _emb == "2":
            # band-or-floor: out-of-band window minima still advance when
            # they are in the global top-rank slice — bounds the sweep
            # count like the default throttle while keeping most of the
            # band's cross-region arbitration.
            valid = valid & (e_ok | (rank < floor_dyn))

    pop_u = state.cand_u[idx]
    pop_v = state.cand_v[idx]

    # CONTESTED-ACCEPT DEFERRAL (FALDOI_GROW_DEFER=<flow tol px>): accepts
    # that commute may land in the same sweep without changing the serial
    # outcome; the ones that DON'T commute are exactly where the reference's
    # strict pop order decides the flow — a lower-energy accept within patch
    # reach whose flow disagrees would, serially, have claimed territory /
    # donated its flow before us.  Defer those: scatter this sweep's
    # tentative accepts' (e, u, v) onto the grid, window-reduce over the
    # patch-overlap neighbourhood, and drop any accept that sees a strictly
    # lower-energy neighbour while the neighbourhood's accepted flows spread
    # more than the tolerance.  The window-min holder itself is never
    # deferred, so progress is guaranteed; smooth regions (flow spread
    # within tol) are untouched, so the sweep count only grows along
    # motion discontinuities.  Under spatial sharding the reduction runs
    # per shard: contests across a shard boundary are not seen (the halo
    # merge's scatter-min still arbitrates the VALUES; only the deferral
    # heuristic is shard-local).  In relax mode the comparison key carries
    # RECLAIM_BIAS for re-claims, which makes deferral strictly more
    # conservative there (re-claims rank behind all frontier accepts).
    _defer = dials[2]
    if _defer > 0:
        wsz = dials[3] or (2 * wr + 1)
        acc_i = jnp.where(valid, idx, dump)
        acc_e = jnp.where(valid, e_pop, jnp.inf)
        inf1 = jnp.full((n + 1,), jnp.inf, e_pop.dtype)
        e_pl = inf1.at[acc_i].min(acc_e)[:n].reshape(h, w)
        u_lo = inf1.at[acc_i].min(jnp.where(valid, pop_u, jnp.inf))[:n]
        u_hi = (-inf1).at[acc_i].max(jnp.where(valid, pop_u, -jnp.inf))[:n]
        v_lo = inf1.at[acc_i].min(jnp.where(valid, pop_v, jnp.inf))[:n]
        v_hi = (-inf1).at[acc_i].max(jnp.where(valid, pop_v, -jnp.inf))[:n]

        def _wred(p2, init, op):
            r = jax.lax.reduce_window(p2, init, op, (1, wsz), (1, 1), "SAME")
            return jax.lax.reduce_window(r, init, op, (wsz, 1), (1, 1),
                                         "SAME")

        wmin_e = _wred(e_pl, jnp.inf, jax.lax.min)
        wlo_u = _wred(u_lo.reshape(h, w), jnp.inf, jax.lax.min)
        whi_u = _wred(u_hi.reshape(h, w), -jnp.inf, jax.lax.max)
        wlo_v = _wred(v_lo.reshape(h, w), jnp.inf, jax.lax.min)
        whi_v = _wred(v_hi.reshape(h, w), -jnp.inf, jax.lax.max)
        spread = ((whi_u - wlo_u > _defer) | (whi_v - wlo_v > _defer))
        contested2 = (spread & jnp.isfinite(wmin_e)).reshape(n)
        lower2 = wmin_e.reshape(n)
        cont_at = jnp.concatenate([contested2, jnp.zeros((1,), bool)])[idx]
        wmin_at = jnp.concatenate([lower2, jnp.full((1,), jnp.inf)])[idx]
        contested = cont_at & (wmin_at < e_pop - 1e-6)
        valid = valid & ~contested

    idx_s = jnp.where(valid, idx, dump)
    n_acc = valid.sum()

    ymin, ymax = (0, h) if ybounds is None else ybounds
    i, j, oy, ox, ph, pw = _patch_geometry(idx, h, w, wr, ymin, ymax)

    # --- fix accepted candidates (local_growing pop, :899-937)
    pop_e = state.cand_e[idx]
    pop_c = state.cand_chi[idx]
    fixed = state.fixed.at[idx_s].set(True)
    out_u = state.out_u.at[idx_s].set(pop_u)
    out_v = state.out_v.at[idx_s].set(pop_v)
    out_chi = (state.out_chi.at[idx_s].set(pop_c) if with_chi
               else state.out_chi)
    ene = state.ene.at[idx_s].set(pop_e)
    cand_e = state.cand_e.at[idx_s].set(jnp.inf)

    rows, cols = _rowcol_ids((p, p))

    # --- per-patch init (add_neighbors :688-705)
    # All state planes are stacked channels-LAST and cropped with ONE
    # vmapped dynamic_slice per patch (one batched gather of (p, p, C)
    # windows instead of one per plane).
    # The chi planes ride along only for the occlusion method (with_chi).
    # No separate fixed channel (r4): out_u is finite IFF the pixel is
    # fixed (fix writes finite pops, donations only hit accepted pixels,
    # requeues reset unfixed out_u to NaN), so fxp = isfinite(ou) & inbox.
    # ``lean``: iteration-0 specialisation — use_fill is always true, so the
    # working-flow/trust channels are never read; crop only 2 channels.
    lean = first_iter and fill != "dense" and not with_chi
    planes = [
        out_u[:n].reshape(h, w),
        out_v[:n].reshape(h, w),
    ]
    if not lean:
        planes += [
            state.wu[:n].reshape(h, w),
            state.wv[:n].reshape(h, w),
            trust2d,
        ]
    if with_chi:
        planes.append(out_chi[:n].reshape(h, w))
        planes.append(state.wchi[:n].reshape(h, w))
    if fill == "dense":
        fixed2d = fixed[:n].reshape(h, w)
        planes.append(_dense_fill(fixed2d, out_u[:n].reshape(h, w)))
        planes.append(_dense_fill(fixed2d, out_v[:n].reshape(h, w)))
    stack = jnp.pad(
        jnp.stack(planes, axis=-1), ((0, p), (0, p), (0, 0)), mode="edge"
    )
    chi_ch = 5 if with_chi else None
    fill_ch = 7 if with_chi else 5

    def build_init(oy_k, ox_k, ph_k, pw_k):
        inbox = (rows < ph_k) & (cols < pw_k)
        pl = crop_padded(stack, oy_k, ox_k, p)
        ou, ov = pl[..., 0], pl[..., 1]
        fxp = jnp.isfinite(ou) & inbox
        if lean:
            wu_p = wv_p = jnp.full_like(ou, jnp.nan)
            tr = jnp.ones_like(ou)
        else:
            wu_p, wv_p = pl[..., 2], pl[..., 3]
            tr = pl[..., 4]
        if fill == "dense":
            fill_u, fill_v = pl[..., fill_ch], pl[..., fill_ch + 1]
        else:
            # "patch_rb" = red-black relaxation (cheap, parity-validated for
            # the TVL1/NLTV families); "patch" = reference-exact raster GS
            # (required by the inert-TV CSAD family m4-m7 — see ops/poisson).
            # u and v fill as ONE channel-vmapped chain: the fill is
            # latency-bound (~30 sequential tiny ops), so halving the op
            # count halves its per-sweep cost (channels are independent in
            # the reference too, elap_recsep.c:225-232).
            ex = fill != "patch_rb"
            fuv = jax.vmap(
                lambda cc: poisson_fill_canvas(cc, ph_k, pw_k, exact=ex),
                in_axes=-1, out_axes=-1,
            )(jnp.stack([jnp.where(fxp, ou, jnp.nan),
                         jnp.where(fxp, ov, jnp.nan)], axis=-1))
            fill_u, fill_v = fuv[..., 0], fuv[..., 1]
        if lean:
            u0, v0 = fill_u, fill_v
            alt_u = alt_v = None
        else:
            alt_u = jnp.where(fxp, ou, wu_p)
            alt_v = jnp.where(fxp, ov, wv_p)
            bad_alt = jnp.any(
                inbox & ~(jnp.isfinite(alt_u) & jnp.isfinite(alt_v)))
            untrusted = jnp.any(inbox & (tr == 0))
            use_fill = (iteration == 0) | untrusted | bad_alt
            if "nofill" in _ablate:
                use_fill = jnp.asarray(False)
                alt_u = jnp.nan_to_num(alt_u)
                alt_v = jnp.nan_to_num(alt_v)
            u0 = jnp.where(use_fill, fill_u, alt_u)
            v0 = jnp.where(use_fill, fill_v, alt_v)
        if with_chi:
            oc, wc_p = pl[..., chi_ch], pl[..., chi_ch + 1]
            # chi init: fixed px use out values, else working chi (0 default)
            c0 = jnp.where(fxp, oc, jnp.where(jnp.isfinite(wc_p), wc_p, 0.0))
            c0 = jnp.where(inbox, c0, 0.0)
        else:
            c0 = jnp.zeros_like(u0)
        return (jnp.where(inbox, u0, 0.0), jnp.where(inbox, v0, 0.0), c0)

    # batch-minor layout: canvases are (P, P, B)
    u_init, v_init, c_init = jax.vmap(build_init, out_axes=-1)(oy, ox, ph, pw)

    # --- batched patch PD solve (of_estimation dispatcher)
    # row_offset translates extended-domain rows to GLOBAL rows: the solver
    # reads the (replicated) full-image planes and warps in global coords
    roff = 0 if row_offset is None else row_offset

    def solve(i_k, j_k, oy_k, ox_k, ph_k, pw_k, u0, v0, c0):
        return solver(sconsts, i_k, j_k + roff, oy_k + roff, ox_k,
                      ph_k, pw_k, u0, v0, c0, p, warps, max_iters, wr)

    if "nosolve" in _ablate:
        su, sv, schi = u_init, v_init, c_init
        ener = jnp.sum(u_init, axis=(0, 1)) * 1e-6
    else:
        su, sv, schi, ener = jax.vmap(
            solve, in_axes=(0, 0, 0, 0, 0, 0, -1, -1, -1),
            out_axes=(-1, -1, -1, 0)
        )(i, j, oy, ox, ph, pw, u_init, v_init, c_init)

    cy = j - oy
    cx = i - ox
    bidx = jnp.arange(bsz)

    # --- 4-neighbour propagation (insert_candidates :497-537)
    # Two targets: unfixed neighbours get queue candidates; neighbours that
    # were accepted THIS sweep get "donations" — in the serial reference, a
    # lower-energy pop p would have improved q's queue entry before q popped;
    # the donation scatter-min reproduces that intra-batch information flow
    # (the key fidelity mechanism that makes large sweeps track the strict
    # priority order).
    # All four directions go through ONE (4*bsz,) scatter pair: the
    # scatter-min makes per-direction sequencing redundant (collisions
    # resolve to the same minimum either way; ties may pick a different
    # equal-energy payload), and one scatter over 4*bsz updates replaces
    # 32 separate scatter ops.
    prev_fixed = state.fixed
    cand_u, cand_v, cand_chi = state.cand_u, state.cand_v, state.cand_chi
    qs, es, nus, nvs, ncs, oks, okds = [], [], [], [], [], [], []
    for (dx, dy) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        qi = i + dx
        qj = j + dy
        inb = (qi >= 0) & (qi < w) & (qj >= ymin) & (qj < ymax) & valid
        q = jnp.where(inb, qj * w + qi, dump)
        new_e = ener * sal[q]
        if relax:
            ok = inb & (new_e < cand_e[q]) & (
                new_e < ene[q] * relax_margin - 1e-6
            )
        else:
            ok = inb & ~fixed[q] & (new_e < cand_e[q])
        accepted_now = fixed[q] & ~prev_fixed[q]
        ok_don = inb & accepted_now & (new_e < ene[q])
        qs.append(q)
        es.append(new_e)
        nus.append(su[cy + dy, cx + dx, bidx])
        nvs.append(sv[cy + dy, cx + dx, bidx])
        if with_chi:
            ncs.append(schi[cy + dy, cx + dx, bidx])
        oks.append(ok)
        okds.append(ok_don)
    q4 = jnp.concatenate(qs)
    e4 = jnp.concatenate(es)
    nu4 = jnp.concatenate(nus)
    nv4 = jnp.concatenate(nvs)
    nc4 = jnp.concatenate(ncs) if with_chi else None
    cand_chi_t = cand_chi if with_chi else None
    out_chi_t = out_chi if with_chi else None
    cand_e, cand_u, cand_v, cand_chi_t = _scatter_min_payload(
        cand_e, cand_u, cand_v, cand_chi_t, q4, e4, nu4, nv4, nc4,
        jnp.concatenate(oks), dump,
    )
    ene, out_u, out_v, out_chi_t = _scatter_min_payload(
        ene, out_u, out_v, out_chi_t, q4, e4, nu4, nv4, nc4,
        jnp.concatenate(okds), dump,
    )
    if with_chi:
        cand_chi, out_chi = cand_chi_t, out_chi_t

    # --- centre update (add_neighbors :718-726), after donations so the
    # comparison target matches the serial pop value
    s_cu = su[cy, cx, bidx]
    s_cv = sv[cy, cx, bidx]
    better = valid & (ener < ene[idx_s])
    upd = jnp.where(better, idx, dump)
    out_u = out_u.at[upd].set(s_cu)
    out_v = out_v.at[upd].set(s_cv)
    if with_chi:
        out_chi = out_chi.at[upd].set(schi[cy, cx, bidx])
    ene = ene.at[upd].set(jnp.where(better, ener, jnp.inf))

    # --- persistent working-flow scatter (max-energy wins == later-pop wins)
    # FALDOI_WSCATTER_R < wr writes only the central (2r+1)^2 cells of each
    # solved patch instead of the full patch: the scatter's cost grows with
    # its update count, and the working flow is an init heuristic — cells
    # beyond the write radius keep an older (previous sweep's) init.  5 = reference semantics (guided_* writes u1/u2 over
    # the whole patch).  Edge-clamped patches write a centre-shifted window
    # (still inside the patch box) — init-staleness only, parity-measured.
    _wr_r = dials[6] if len(dials) > 6 else wr
    if _wr_r < wr:
        lo, hi = wr - _wr_r, wr + _wr_r + 1
        w_rows = rows[lo:hi, :]        # rows is (p, 1), cols is (1, p)
        w_cols = cols[:, lo:hi]
        w_su, w_sv = su[lo:hi, lo:hi], sv[lo:hi, lo:hi]
        w_schi = schi[lo:hi, lo:hi] if with_chi else None
    else:
        w_rows, w_cols, w_su, w_sv = rows, cols, su, sv
        w_schi = schi if with_chi else None
    gy = oy[None, None, :] + w_rows[..., None]
    gx = ox[None, None, :] + w_cols[..., None]
    inbox = (w_rows[..., None] < ph[None, None, :]) & (
        w_cols[..., None] < pw[None, None, :]
    )
    cell_ok = inbox & valid[None, None, :]
    flat_q = jnp.where(cell_ok, gy * w + gx, dump).reshape(-1)
    key = jnp.broadcast_to(ener[None, None, :], w_su.shape).reshape(-1)
    key_buf = jnp.full((n + 1,), -jnp.inf, jnp.float32)
    if "nowscatter" in _ablate:
        wkey, wu, wv, wchi = key_buf, state.wu, state.wv, state.wchi
    else:
        wkey, wu, wv, wchi = _scatter_max_payload(
            key_buf, state.wu, state.wv,
            state.wchi if with_chi else None, flat_q, key,
            w_su.reshape(-1), w_sv.reshape(-1),
            w_schi.reshape(-1) if with_chi else None,
            cell_ok.reshape(-1), dump,
            # cross-shard merges consume the key plane -> exact required
            exact=True if with_wkey else (dials[4] == "exact"),
        )
    if not with_chi:
        wchi = state.wchi

    new_state = GrowState(fixed, out_u, out_v, ene, cand_u, cand_v, cand_e,
                          wu, wv, out_chi, cand_chi, wchi)
    if with_wkey:
        return new_state, n_acc, wkey
    return new_state, n_acc


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver", "h", "w", "wr", "bsz", "warps", "max_iters",
        "fill", "relax", "block", "with_chi", "first_iter", "dials",
    ),
)
def grow_to_completion(
    state: GrowState,
    solver, sconsts,
    trust, sal, iteration,
    h: int, w: int, wr: int, bsz: int,
    warps: int, max_iters: int, delta: float = float("inf"),
    fill: str = "patch", floor=None, relax: bool = True,
    relax_margin: float = 0.95, delta_rel: float = 0.0,
    floor_scale: int = 0, block: int = 0, with_chi: bool = True,
    floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
    first_iter: bool = False, dials: tuple = None,
):
    """Run wavefront sweeps until the candidate queue drains — a single
    device program (lax.while_loop over sweeps)."""
    n = h * w
    p = 2 * wr + 1
    trust2d = trust[:n].reshape(h, w).astype(jnp.float32)

    def cond(carry):
        _, n_acc, sweeps = carry
        return n_acc > 0

    def body(carry):
        st, _, sweeps = carry
        st, n_acc = _sweep_body(
            st, solver, sconsts, trust2d, sal, iteration,
            h, w, wr, bsz, warps, max_iters,
            delta=delta, fill=fill, floor=floor, relax=relax,
            relax_margin=relax_margin, delta_rel=delta_rel,
            floor_scale=floor_scale, block=block, with_chi=with_chi,
            floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
            first_iter=first_iter, dials=dials,
        )
        return (st, n_acc, sweeps + 1)

    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32))
    state, _, sweeps = jax.lax.while_loop(cond, body, carry)
    return state, sweeps


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver", "h", "w", "wr", "bsz", "warps", "max_iters",
        "fill", "relax", "block", "with_chi", "first_iter", "dials",
    ),
)
def grow_step(
    state: GrowState,
    solver, sconsts,
    trust, sal, iteration,
    h: int, w: int, wr: int, bsz: int,
    warps: int, max_iters: int, delta: float = float("inf"),
    fill: str = "patch", floor=None, relax: bool = True,
    relax_margin: float = 0.95, delta_rel: float = 0.0,
    floor_scale: int = 0, block: int = 0, with_chi: bool = True,
    floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
    first_iter: bool = False, dials: tuple = None,
):
    """One sweep per dispatch — for debugging sweep by sweep."""
    n = h * w
    p = 2 * wr + 1
    trust2d = trust[:n].reshape(h, w).astype(jnp.float32)
    return _sweep_body(
        state, solver, sconsts, trust2d, sal, iteration,
        h, w, wr, bsz, warps, max_iters,
        delta=delta, fill=fill, floor=floor, relax=relax,
        relax_margin=relax_margin, delta_rel=delta_rel,
        floor_scale=floor_scale, block=block, with_chi=with_chi,
        floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
        first_iter=first_iter, dials=dials,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver", "h", "w", "wr", "bsz", "warps", "max_iters",
        "chunk", "fill", "relax", "block", "with_chi", "first_iter",
        "dials",
    ),
)
def grow_chunk(
    state: GrowState,
    solver, sconsts,
    trust, sal, iteration,
    h: int, w: int, wr: int, bsz: int,
    warps: int, max_iters: int, delta: float = float("inf"),
    chunk: int = 8, fill: str = "patch", floor=None, relax: bool = True,
    relax_margin: float = 0.95, delta_rel: float = 0.0,
    floor_scale: int = 0, block: int = 0, with_chi: bool = True,
    floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
    first_iter: bool = False, dials: tuple = None,
):
    """Up to ``chunk`` sweeps per dispatch — bounded launches with a
    device-side early exit, synced with the host between chunks."""
    n = h * w
    p = 2 * wr + 1
    trust2d = trust[:n].reshape(h, w).astype(jnp.float32)

    def cond(carry):
        _, n_acc, k = carry
        return jnp.logical_and(n_acc > 0, k < chunk)

    def body(carry):
        st, _, k = carry
        st, n_acc = _sweep_body(
            st, solver, sconsts, trust2d, sal, iteration,
            h, w, wr, bsz, warps, max_iters,
            delta=delta, fill=fill, floor=floor, relax=relax,
            relax_margin=relax_margin, delta_rel=delta_rel,
            floor_scale=floor_scale, block=block, with_chi=with_chi,
            floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
            first_iter=first_iter, dials=dials,
        )
        return (st, n_acc, k + 1)

    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32))
    state, n_acc, _ = jax.lax.while_loop(cond, body, carry)
    return state, n_acc


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver", "h", "w", "wr", "bsz", "warps", "max_iters",
        "chunk", "fill", "relax", "block", "with_chi", "first_iter",
        "dials", "lanes",
    ),
)
def grow_chunk_pair(
    st2: GrowState,              # stacked (L, ...) lane states
    solver, sc2,                 # stacked (L, ...) SolverConsts
    trust2, sal2, iteration,     # stacked (L, n+1) trust / saliency
    h: int, w: int, wr: int, bsz: int,
    warps: int, max_iters: int, delta: float = float("inf"),
    chunk: int = 8, fill: str = "patch", floor=None, relax: bool = True,
    relax_margin: float = 0.95, delta_rel: float = 0.0,
    floor_scale: int = 0, block: int = 0, with_chi: bool = True,
    floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
    first_iter: bool = False, dials: tuple = None, lanes: int = None,
):
    """Bounded-chunk drain of all L growing lanes in one program.

    The reference runs fwd/bwd growings as an OpenMP task pair
    (local_faldoi.cpp:1191-1219); here every lane's sweep runs in one
    device program — one dispatch instead of L.  The classic case is L=2
    (fwd, bwd) of one frame pair; the multi-pair throughput mode
    (``match_growing_pairs``) stacks N pairs as L=2N lanes
    [fwd0..fwdN-1, bwd0..bwdN-1], sharing each dispatch and host sync
    among N pairs.

    ``lanes`` = how many LEADING lanes sweep (None = all): the final
    forward-only growing (local_faldoi.cpp:1636-1712) passes the number of
    fwd lanes; the trailing bwd lanes are carried untouched.

    Per-lane early-exit: each sweep is wrapped in ``lax.cond`` on the
    lane's previous-sweep acceptance.  Acceptance is monotone within a
    drain (lanes are independent: once a lane accepts nothing its
    eligibility can never change until the host re-queues), so a drained
    lane's remaining sweeps cost ~nothing — essential with mixed-difficulty
    pairs whose sweep counts differ.
    """
    n = h * w
    L = trust2.shape[0]
    drain = L if lanes is None else lanes
    trust2d = jax.vmap(
        lambda t: t[:n].reshape(h, w).astype(jnp.float32)
    )(trust2)

    def sweep_one(s, sc, tr, sal, it):
        return _sweep_body(
            s, solver, sc, tr, sal, it,
            h, w, wr, bsz, warps, max_iters,
            delta=delta, fill=fill, floor=floor, relax=relax,
            relax_margin=relax_margin, delta_rel=delta_rel,
            floor_scale=floor_scale, block=block, with_chi=with_chi,
            floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
            first_iter=first_iter, dials=dials,
        )

    def sweep_pair(s2, sc2_, tr2, sal2_, it, prev_acc):
        # UNROLLED lanes, not vmap: L single-lane sweeps in one program
        # keep each lane's own lax.cond early exit.  Values identical
        # (lanes are independent).
        outs, accs = [], []
        for lane in range(L):
            s_l = jax.tree.map(lambda a: a[lane], s2)
            if lane < drain:
                sc_l = jax.tree.map(lambda a: a[lane], sc2_)
                tr_l = tr2[lane]
                sal_l = sal2_[lane]
                s_l, acc = jax.lax.cond(
                    prev_acc[lane] > 0,
                    lambda s, sc=sc_l, tr=tr_l, sl=sal_l:
                        sweep_one(s, sc, tr, sl, it),
                    lambda s: (s, jnp.asarray(0, jnp.int32)),
                    s_l,
                )
            else:
                acc = jnp.asarray(0, jnp.int32)
            outs.append(s_l)
            accs.append(acc)
        s2n = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
        return s2n, jnp.stack(accs)

    def cond(carry):
        _, n_acc, _mx, k = carry
        return jnp.logical_and(n_acc.sum() > 0, k < chunk)

    def body(carry):
        s, acc, mx, k = carry
        s, acc = sweep_pair(s, sc2, trust2d, sal2, iteration, acc)
        return (s, acc, jnp.maximum(mx, acc.max()), k + 1)

    carry = (st2, jnp.ones((L,), jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32))
    st2, n_acc, max_acc, _ = jax.lax.while_loop(cond, body, carry)
    # max_acc = the largest single-sweep acceptance in this chunk — the
    # caller's signal for adaptive batch sizing (max_acc == bsz means the
    # top-k cut truncated the acceptance band: upshift)
    return st2, n_acc, max_acc


@functools.partial(
    jax.jit,
    static_argnames=("solver", "h", "w", "bsz", "warps", "max_iters",
                     "with_chi"),
)
def seed_batch(
    state: GrowState,
    seed_idx,                     # (bsz,) flat indices (dump-padded)
    seed_u, seed_v,               # (bsz,) seed flow
    seed_valid,                   # (bsz,) bool
    solver, sconsts,
    sal,
    h: int, w: int, bsz: int,
    warps: int, max_iters: int, with_chi: bool = True,
):
    """insert_initial_seeds (:748-796): 3x3 solves around each seed with only
    the seed fixed; pushes 4-neighbour candidates; seeds themselves are fixed
    afterwards by the caller."""
    n = h * w
    dump = n
    wr = 1
    p = 3
    idx = seed_idx
    i, j, oy, ox, ph, pw = _patch_geometry(idx, h, w, wr)
    rows, cols = _rowcol_ids((p, p))

    def build_init(oy_k, ox_k, ph_k, pw_k, j_k, i_k, u_k, v_k):
        inbox = (rows < ph_k) & (cols < pw_k)
        is_center = ((oy_k + rows) == j_k) & ((ox_k + cols) == i_k)
        fuv = jax.vmap(
            lambda cc: poisson_fill_canvas(cc, ph_k, pw_k),
            in_axes=-1, out_axes=-1,
        )(jnp.stack([jnp.where(is_center, u_k, jnp.nan),
                     jnp.where(is_center, v_k, jnp.nan)], axis=-1))
        return jnp.where(inbox, fuv[..., 0], 0.0), jnp.where(inbox, fuv[..., 1], 0.0)

    u_init, v_init = jax.vmap(build_init, out_axes=-1)(
        oy, ox, ph, pw, j, i, seed_u, seed_v
    )
    c_init = jnp.zeros_like(u_init)

    def solve(i_k, j_k, oy_k, ox_k, ph_k, pw_k, u0, v0, c0):
        return solver(sconsts, i_k, j_k, oy_k, ox_k, ph_k, pw_k, u0, v0, c0,
                      p, warps, max_iters, 1)

    su, sv, schi, ener = jax.vmap(
        solve, in_axes=(0, 0, 0, 0, 0, 0, -1, -1, -1), out_axes=(-1, -1, -1, 0)
    )(i, j, oy, ox, ph, pw, u_init, v_init, c_init)

    cy = j - oy
    cx = i - ox
    bidx = jnp.arange(bsz)
    cand_u, cand_v, cand_e = state.cand_u, state.cand_v, state.cand_e
    cand_chi = state.cand_chi if with_chi else None
    qs, es, nus, nvs, ncs, oks = [], [], [], [], [], []
    for (dx, dy) in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        qi = i + dx
        qj = j + dy
        inb = (qi >= 0) & (qi < w) & (qj >= 0) & (qj < h) & seed_valid
        q = jnp.where(inb, qj * w + qi, dump)
        new_e = ener * sal[q]
        qs.append(q)
        es.append(new_e)
        oks.append(inb & (new_e < cand_e[q]))
        # su/sv/schi are (p, p, bsz) — lane axis LAST (out_axes=-1 above);
        # indexing lanes on axis 0 here would clamp bidx to p-1 and hand
        # every candidate a wrong lane's flow (caught vs the reference's
        # queue log: candidate flows off by ~5 px while energies matched)
        nus.append(su[cy + dy, cx + dx, bidx])
        nvs.append(sv[cy + dy, cx + dx, bidx])
        if with_chi:
            ncs.append(schi[cy + dy, cx + dx, bidx])
    cand_e, cand_u, cand_v, cand_chi = _scatter_min_payload(
        cand_e, cand_u, cand_v, cand_chi, jnp.concatenate(qs),
        jnp.concatenate(es), jnp.concatenate(nus), jnp.concatenate(nvs),
        jnp.concatenate(ncs) if with_chi else None,
        jnp.concatenate(oks), dump,
    )

    gy = oy[None, None, :] + rows[..., None]
    gx = ox[None, None, :] + cols[..., None]
    inbox = (rows[..., None] < ph[None, None, :]) & (
        cols[..., None] < pw[None, None, :]
    )
    cell_ok = inbox & seed_valid[None, None, :]
    flat_q = jnp.where(cell_ok, gy * w + gx, dump).reshape(-1)
    key = jnp.broadcast_to(ener[None, None, :], su.shape).reshape(-1)
    key_buf = jnp.full((n + 1,), -jnp.inf, jnp.float32)
    _, wu, wv, wchi = _scatter_max_payload(
        key_buf, state.wu, state.wv,
        state.wchi if with_chi else None, flat_q, key,
        su.reshape(-1), sv.reshape(-1),
        schi.reshape(-1) if with_chi else None,
        cell_ok.reshape(-1), dump,
    )
    return state._replace(
        cand_u=cand_u, cand_v=cand_v, cand_e=cand_e,
        cand_chi=cand_chi if with_chi else state.cand_chi,
        wu=wu, wv=wv, wchi=wchi if with_chi else state.wchi)


@jax.jit
def _refix_seeds(state: GrowState, idx, su, sv) -> GrowState:
    """Overwrite seed pixels with their original flow at zero energy
    (local_faldoi.cpp:785-795), one program instead of five eager scatters
    (fewer programs to compile in a fresh process)."""
    return state._replace(
        fixed=state.fixed.at[idx].set(True),
        out_u=state.out_u.at[idx].set(su),
        out_v=state.out_v.at[idx].set(sv),
        ene=state.ene.at[idx].set(0.0),
        cand_e=state.cand_e.at[idx].set(jnp.inf),
    )


class LocalSolver:
    """Orchestrates the iterated local growing for one direction pair
    (``match_growing_variational``, local_faldoi.cpp:1060-1741)."""

    def __init__(self, h, w, wr=5, bsz=4096, solver=solve_tvl1,
                 warps=1, max_iters=4, seed_bsz=2048,
                 mode="fused", delta=float("inf"), chunk=16, fused=None,
                 fill="patch", floor=None, relax=True, relax_margin=0.95,
                 delta_rel=0.0, floor_scale=0, block=0, with_chi=True,
                 floor_scale_hi=0, queue_hi=1 << 30):
        bsz = min(bsz, h * w)
        self.h, self.w, self.wr, self.bsz = h, w, wr, bsz
        self.seed_bsz = seed_bsz
        self.solver = solver
        if fused is not None:  # back-compat boolean
            mode = "fused" if fused else "step"
        self.mode = mode
        self.delta = delta
        self.chunk = chunk
        self.fill = fill
        # relaxation converges by re-claiming, so default to accepting the
        # whole top-k batch; the strict-order mode defaults to bsz//16
        self.floor = (bsz if relax else None) if floor is None else floor
        self.relax = relax
        self.relax_margin = relax_margin
        self.delta_rel = delta_rel
        self.floor_scale = floor_scale
        self.floor_scale_hi = floor_scale_hi
        self.queue_hi = queue_hi
        self.block = block
        self.kw = dict(warps=warps, max_iters=max_iters, with_chi=with_chi,
                       floor_scale_hi=floor_scale_hi, queue_hi=queue_hi)

    def insert_seeds(self, state: GrowState, seeds: np.ndarray,
                     sconsts, sal) -> GrowState:
        """seeds: (h, w, 2) NaN-sparse field."""
        h, w = self.h, self.w
        n = h * w
        su = np.asarray(seeds[:, :, 0]).ravel()
        sv = np.asarray(seeds[:, :, 1]).ravel()
        pos = np.nonzero(np.isfinite(su) & np.isfinite(sv))[0]
        b = self.seed_bsz
        for k0 in range(0, max(len(pos), 1), b):
            chunk = pos[k0 : k0 + b]
            pad = b - len(chunk)
            idx = jnp.asarray(np.pad(chunk, (0, pad), constant_values=n))
            cu = jnp.asarray(np.pad(su[chunk], (0, pad)))
            cv = jnp.asarray(np.pad(sv[chunk], (0, pad)))
            vmask = jnp.asarray(np.pad(np.ones(len(chunk), bool), (0, pad)))
            state = seed_batch(
                state, idx, cu, cv, vmask, self.solver, sconsts, sal,
                h, w, b, warps=self.kw["warps"],
                max_iters=self.kw["max_iters"],
                with_chi=self.kw["with_chi"],
            )
        # re-fix seeds with original flow and zero energy (:785-795); pad
        # the index list to a seed_bsz multiple so the jitted program is
        # shared across directions (extra entries hit the n dump slot,
        # which the unpadded version wrote identically)
        npad = -(len(pos) + 1) % b
        idx = jnp.asarray(np.concatenate([pos, np.full(npad + 1, n)]))
        return _refix_seeds(
            state, idx,
            jnp.asarray(np.concatenate([su[pos], np.zeros(npad + 1)]),
                        jnp.float32),
            jnp.asarray(np.concatenate([sv[pos], np.zeros(npad + 1)]),
                        jnp.float32),
        )

    def grow(self, state: GrowState, sconsts, trust, sal, iteration,
             max_sweeps=100000, snapshot_cb=None) -> GrowState:
        """Run sweeps until the candidate queue is empty.

        snapshot_cb(state, fixed_fraction) is invoked at sync points in the
        step/chunked modes — the partial-results hook (the reference dumps
        growing snapshots at 30/70/80/95/100%, local_faldoi.cpp:944-1036).
        """
        fi = _lean_enabled() and isinstance(iteration, int) and iteration == 0
        it = jnp.asarray(iteration, jnp.int32)
        self.last_sweeps = 0
        if snapshot_cb is not None and self.mode == "fused":
            self.mode = "chunked"  # snapshots need host sync points
        if self.mode == "fused":
            state, _sweeps = grow_to_completion(
                state, self.solver, sconsts, trust, sal, it,
                self.h, self.w, self.wr, self.bsz, delta=self.delta,
                fill=self.fill, floor=self.floor, relax=self.relax,
                relax_margin=self.relax_margin, delta_rel=self.delta_rel,
                floor_scale=self.floor_scale, block=self.block,
                first_iter=fi, dials=ordering_dials(), **self.kw
            )
            self.last_sweeps = int(_sweeps)
            return state
        if self.mode == "chunked":
            for _ in range(max_sweeps):
                state, n_acc = grow_chunk(
                    state, self.solver, sconsts, trust, sal, it,
                    self.h, self.w, self.wr, self.bsz, delta=self.delta,
                    chunk=self.chunk, fill=self.fill, floor=self.floor,
                    relax=self.relax, relax_margin=self.relax_margin,
                    delta_rel=self.delta_rel, floor_scale=self.floor_scale,
                    block=self.block, first_iter=fi,
                    dials=ordering_dials(), **self.kw
                )
                self.last_sweeps += self.chunk
                if snapshot_cb is not None:
                    n = self.h * self.w
                    frac = float(state.fixed[:n].sum()) / n
                    snapshot_cb(state, frac)
                if int(n_acc) == 0:
                    break
            return state
        # step mode: pipeline dispatches — sync n_acc only every
        # `chunk` sweeps so the host->device round-trip overlaps with
        # device execution; trailing empty sweeps are no-ops.
        return self._grow_step_mode(state, sconsts, trust, sal, it,
                                    max_sweeps, first_iter=fi)

    def grow_pair(self, st2, sc2, trust2, sal2, iteration,
                  max_sweeps=100000, snapshot_cb=None):
        """Drain every lane's queue as one stacked device batch (chunked
        dispatches).  ``st2``/``sc2``/``trust2``/``sal2`` carry a leading
        lane axis (fwd, bwd for one pair).

        Dispatch is PIPELINED: the drain check reads the previous chunk's
        acceptance count while the next chunk is already running, so the
        device does not idle while the host waits; the one trailing chunk
        after a drain is all no-op sweeps (empty top-k).

        ADAPTIVE BATCH: the sweep cost grows with bsz while the delta-band
        acceptance averages a few hundred lanes in the long sparse phases,
        so each chunk runs at the smallest ladder rung covering the
        previous chunk's peak acceptance.  The accept rule is
        bsz-INVARIANT (the rank floor is pinned to the nominal bsz//16, so
        the accepted set only depends on bsz through top-k truncation,
        which is caught by max_acc == bsz and upshifted next chunk —
        truncation only makes the order stricter, never looser).
        """
        fi = _lean_enabled() and isinstance(iteration, int) and iteration == 0
        it = jnp.asarray(iteration, jnp.int32)
        self.last_sweeps = 0
        pending = None
        dials = ordering_dials()
        # pin the rank floor to the NOMINAL batch so adaptation cannot
        # change the acceptance rule
        floor = self.floor
        if floor is None:
            floor = self.bsz if self.relax else max(1, self.bsz // 16)
        # power-of-two ladder: every distinct bsz is a separate compiled
        # program; FALDOI_GROW_LADDER=csv overrides the rung set (fewer
        # rungs, fewer programs to compile)
        lad = os.environ.get("FALDOI_GROW_LADDER")
        if lad:
            rungs = tuple(int(x) for x in lad.split(","))
        else:
            rungs = (512, 1024, 2048, 4096, 8192)
        ladder = tuple(b for b in rungs if b < self.bsz)
        ladder = ladder + (self.bsz,)
        # READY-RUNG SCHEDULING (FALDOI_GROW_PREWARM=1): the rung programs
        # this drain can reach compile on a background thread, and an
        # upshift to a rung still compiling waits at the current rung
        # instead of blocking the drain on that compile.  The cost is extra
        # sweeps at too-small rungs in a cold process (smaller rungs only
        # truncate top-k harder: parity-safe).
        gate = os.environ.get("FALDOI_GROW_PREWARM", "1") == "1"
        cold = self._sig_key(ladder[min(1, len(ladder) - 1)],
                             fi) not in LocalSolver._prewarmed
        cur = ladder[0] if (gate and cold) else ladder[
            min(1, len(ladder) - 1)]
        if gate:
            self._prewarm(st2, sc2, trust2, sal2, it, ladder, cur, fi,
                          floor, dials)

        def ready(b):
            return not gate or self._compiled(self._sig_key(b, fi))

        for _ in range(max_sweeps):
            st2, n_acc, max_acc = grow_chunk_pair(
                st2, self.solver, sc2, trust2, sal2, it,
                self.h, self.w, self.wr, cur, delta=self.delta,
                chunk=self.chunk, fill=self.fill, floor=floor,
                relax=self.relax, relax_margin=self.relax_margin,
                delta_rel=self.delta_rel, floor_scale=self.floor_scale,
                block=self.block, first_iter=fi, dials=dials,
                lanes=getattr(self, "lanes", None), **self.kw
            )
            LocalSolver._prewarmed.add(self._sig_key(cur, fi))
            self.last_sweeps += self.chunk
            if snapshot_cb is not None:
                n = self.h * self.w
                frac = float(st2.fixed[0, :n].sum()) / n
                snapshot_cb(jax.tree.map(lambda a: a[0], st2), frac)
                if int(n_acc.sum()) == 0:
                    break
                mx = int(max_acc)
            else:
                # PIPELINED ADAPTATION: the next rung reads the PREVIOUS
                # chunk's max_acc (already complete on device), not the
                # one just dispatched; the one-chunk lag only delays an
                # upshift (stricter order, parity-safe)
                if pending is not None and int(pending[0].sum()) == 0:
                    break
                mx = int(pending[1]) if pending is not None else None
                pending = (n_acc, max_acc)
            if mx is None:
                continue
            if mx >= cur and cur < ladder[-1]:
                nxt = ladder[min(ladder.index(cur) + 1, len(ladder) - 1)]
                if ready(nxt):
                    cur = nxt
            elif mx < cur // 3 and cur > ladder[0]:
                # smallest ladder step with headroom over the recent peak
                nxt = next((b for b in ladder if b >= mx + mx // 2),
                           ladder[-1])
                if nxt < cur or ready(nxt):
                    cur = nxt
        for fut in LocalSolver._prewarm_futs.values():
            if fut.done() and not fut.cancelled():
                fut.result()  # re-raise a failed background compile
        return st2

    def _prewarm(self, st2, sc2, trust2, sal2, it, ladder, cur, fi, floor,
                 dials):
        """Queue background compiles of the ladder's rung programs in
        likely-use order: the current rung's upshift chain first, then the
        below-cur rungs, then (during iteration 0 only) the
        first_iter=False variants the requeue drains will need later."""
        from concurrent.futures import ThreadPoolExecutor

        variants = [(b, fi) for b in ladder[ladder.index(cur):]]
        variants += [(b, fi) for b in reversed(ladder[:ladder.index(cur)])]
        if fi:
            variants += [(b, False) for b in reversed(ladder)]

        def call(b, f_):
            # a real (discarded) call, not lower().compile(): only a call
            # populates the jit dispatch cache the drain's own calls hit
            jax.block_until_ready(grow_chunk_pair(
                st2, self.solver, sc2, trust2, sal2, it,
                self.h, self.w, self.wr, b, delta=self.delta,
                chunk=self.chunk, fill=self.fill, floor=floor,
                relax=self.relax, relax_margin=self.relax_margin,
                delta_rel=self.delta_rel, floor_scale=self.floor_scale,
                block=self.block, first_iter=f_, dials=dials,
                lanes=getattr(self, "lanes", None), **self.kw
            ))

        if LocalSolver._prewarm_pool is None:
            LocalSolver._prewarm_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="faldoi-prewarm")
        for b, f_ in variants:
            key = self._sig_key(b, f_)
            if key in LocalSolver._prewarmed or (
                    key in LocalSolver._prewarm_futs
                    and not LocalSolver._prewarm_futs[key].cancelled()):
                continue
            LocalSolver._prewarm_futs[key] = LocalSolver._prewarm_pool.submit(
                call, b, f_)

    @staticmethod
    def _compiled(key) -> bool:
        """Whether the rung program ``key`` is compiled; re-raises the
        exception of a failed background compile."""
        if key in LocalSolver._prewarmed:
            return True
        fut = LocalSolver._prewarm_futs.get(key)
        if fut is None or not fut.done() or fut.cancelled():
            return False
        fut.result()
        LocalSolver._prewarmed.add(key)
        return True

    @staticmethod
    def cancel_prewarm() -> None:
        """Drop the queued background compiles (one already running
        finishes).  Called once no further drain will run, so that the
        process does not compile unused rungs before it can exit."""
        for fut in LocalSolver._prewarm_futs.values():
            fut.cancel()

    def _sig_key(self, b, f_):
        return (self.h, self.w, self.wr, b, f_, self.fill, self.chunk,
                self.relax, self.block, getattr(self, "lanes", None),
                ordering_dials())

    # Rung programs known compiled in this process, the background
    # compiles queued or running, and the one worker thread that runs them.
    _prewarmed: set = set()
    _prewarm_futs: dict = {}
    _prewarm_pool = None

    def _grow_step_mode(self, state, sconsts, trust, sal, it, max_sweeps,
                        first_iter=False):
        k = max(1, self.chunk)
        for i in range(max_sweeps):
            state, n_acc = grow_step(
                state, self.solver, sconsts, trust, sal, it,
                self.h, self.w, self.wr, self.bsz, delta=self.delta,
                fill=self.fill, floor=self.floor, relax=self.relax,
                relax_margin=self.relax_margin, delta_rel=self.delta_rel,
                floor_scale=self.floor_scale, block=self.block,
                first_iter=first_iter, dials=ordering_dials(), **self.kw
            )
            self.last_sweeps = i + 1
            if (i + 1) % k == 0 and int(n_acc) == 0:
                break
        return state


@functools.partial(
    jax.jit,
    static_argnames=("solver", "h", "w", "wr", "bsz", "warps", "max_iters",
                     "with_chi"),
)
def polish_all(state: GrowState, sconsts, sal, solver,
               h: int, w: int, wr: int, bsz: int,
               warps: int, max_iters: int, with_chi: bool = False):
    """One chunk-raster re-polish pass: re-solve EVERY pixel's patch from
    the current dense field and write back the centre flow/energy.

    The reference's outer iterations re-grow the whole image, re-solving
    every pixel's patch with the evolving field as init (the re-queued pops
    of local_faldoi.cpp:813-1036 + 891-1039); warm drains
    (match_growing._warm_requeue) skip that re-solve outside the hole
    bands, trading rg-level parity for time.  A polish pass restores the
    re-solve in batch form: bsz-chunks in raster order, each chunk reading
    the partially-updated planes (chunk-level Gauss-Seidel; within a chunk,
    Jacobi).  No queue machinery — every pixel is re-solved exactly once
    per pass.

    Returns the state with out/ene (and the working flow at centres)
    replaced by the re-solves.  Unfixed/non-finite pixels keep their state.
    """
    n = h * w
    dump = n
    p = 2 * wr + 1
    nchunks = -(-n // bsz)
    rows, cols = _rowcol_ids((p, p))

    def chunk_body(c, carry):
        out_u, out_v, out_chi, ene, wu, wv = carry
        idx = c * bsz + jnp.arange(bsz)
        ok = (idx < n) & state.fixed[jnp.minimum(idx, dump)]
        idx = jnp.minimum(idx, dump)
        i, j, oy, ox, ph, pw = _patch_geometry(idx, h, w, wr)

        planes = [out_u[:n].reshape(h, w), out_v[:n].reshape(h, w)]
        if with_chi:
            planes.append(out_chi[:n].reshape(h, w))
        stack = jnp.pad(jnp.stack(planes, axis=-1),
                        ((0, p), (0, p), (0, 0)), mode="edge")

        def build(oy_k, ox_k, ph_k, pw_k):
            inbox = (rows < ph_k) & (cols < pw_k)
            pl = crop_padded(stack, oy_k, ox_k, p)
            u0 = jnp.where(inbox, jnp.nan_to_num(pl[..., 0]), 0.0)
            v0 = jnp.where(inbox, jnp.nan_to_num(pl[..., 1]), 0.0)
            c0 = (jnp.where(inbox, jnp.nan_to_num(pl[..., 2]), 0.0)
                  if with_chi else jnp.zeros_like(u0))
            return u0, v0, c0

        u0, v0, c0 = jax.vmap(build, out_axes=-1)(oy, ox, ph, pw)
        su, sv, schi, ener = jax.vmap(
            lambda i_k, j_k, oy_k, ox_k, ph_k, pw_k, a, b, cc: solver(
                sconsts, i_k, j_k, oy_k, ox_k, ph_k, pw_k, a, b, cc,
                p, warps, max_iters, wr),
            in_axes=(0, 0, 0, 0, 0, 0, -1, -1, -1), out_axes=(-1, -1, -1, 0)
        )(i, j, oy, ox, ph, pw, u0, v0, c0)

        cy, cx = j - oy, i - ox
        bidx = jnp.arange(bsz)
        cu = su[cy, cx, bidx]
        cv = sv[cy, cx, bidx]
        cc = schi[cy, cx, bidx]
        good = ok & jnp.isfinite(cu) & jnp.isfinite(cv)
        qs = jnp.where(good, idx, dump)
        out_u = out_u.at[qs].set(jnp.where(good, cu, out_u[qs]))
        out_v = out_v.at[qs].set(jnp.where(good, cv, out_v[qs]))
        if with_chi:
            out_chi = out_chi.at[qs].set(jnp.where(good, cc, out_chi[qs]))
        ene = ene.at[qs].set(jnp.where(good, ener * sal[qs], ene[qs]))
        wu = wu.at[qs].set(jnp.where(good, cu, wu[qs]))
        wv = wv.at[qs].set(jnp.where(good, cv, wv[qs]))
        return (out_u, out_v, out_chi, ene, wu, wv)

    out_u, out_v, out_chi, ene, wu, wv = jax.lax.fori_loop(
        0, nchunks, chunk_body,
        (state.out_u, state.out_v, state.out_chi, state.ene,
         state.wu, state.wv),
    )
    return state._replace(out_u=out_u, out_v=out_v, out_chi=out_chi,
                          ene=ene, wu=wu, wv=wv)

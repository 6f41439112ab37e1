"""Iterated FALDOI local minimization — ``match_growing_variational``
(local_faldoi.cpp:1060-1741), batched wavefront edition.

Per outer iteration: forward and backward growings, FB-consistency pruning,
deletion of untrusted flow, re-queueing of survivors; a final forward-only
growing produces the output.  The reference's fwd/bwd OpenMP task pair (P1)
is a stacked device batch here — both directions' sweeps run in one program
on the fused path (``_iterated_growing``) AND on the chunked accelerator
path (``LocalSolver.grow_pair``); its spatial partition threads (P2) are
subsumed by the batched sweeps.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from faldoi_tpu.ops.stencils import centered_gradient
from faldoi_tpu.core.local_step import GrowState, LocalSolver, init_state
from faldoi_tpu.core.functionals import SOLVERS, make_solver_consts
from faldoi_tpu.core.patch_solver import pad_for_crops
from faldoi_tpu.core.pruning import prune
from faldoi_tpu.models import method_local_params
from faldoi_tpu import params as P


@functools.partial(jax.jit, static_argnames=("val_method", "wr", "p"))
def _consts_pair_jit(val_method, i0n, i1n, lam, theta, tau, tol, wr, p):
    """Gradients + crop padding + SolverConsts for BOTH directions as one
    program (run eagerly this chain compiles ~25 single-op programs in a
    fresh process).  Only for methods whose consts are pure jnp
    (TVL1/CSAD families); the NLTV weights need host-side Lab conversion
    and method 8 appends occlusion fields eagerly."""
    i0x, i0y = centered_gradient(i0n)
    i1x, i1y = centered_gradient(i1n)
    sc_go = make_solver_consts(val_method, pad_for_crops(i0n, p), i1n,
                               i1x, i1y, lam, theta, tau, tol, wr=wr, p=p)
    sc_ba = make_solver_consts(val_method, pad_for_crops(i1n, p), i0n,
                               i0x, i0y, lam, theta, tau, tol, wr=wr, p=p)
    return sc_go, sc_ba


_CONSTS_JIT_METHODS = (P.M_TVL1, P.M_TVL1_W, P.M_TVCSAD, P.M_TVCSAD_W)


@jax.jit
def _stack_trees(*trees):
    """Stack N same-structure pytrees on a new leading axis as ONE jitted
    program: the eager per-leaf ``jnp.stack`` calls this replaces compiled
    ~20 single-op programs per pipeline (state 12 planes + solver
    consts)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _delete_untrusted(state: GrowState, trust, n) -> GrowState:
    """delete_not_trustable_candidates (:283-311): NaN flow, inf energy."""
    bad = trust == 0
    nanv = jnp.where(bad, jnp.nan, 0.0)
    return state._replace(
        out_u=jnp.where(bad, jnp.nan, state.out_u),
        out_v=jnp.where(bad, jnp.nan, state.out_v),
        ene=jnp.where(bad, jnp.inf, state.ene),
        wu=state.wu + nanv,   # NaN-poison untrusted working flow
        wv=state.wv + nanv,
        out_chi=jnp.where(bad, 1.0, state.out_chi),  # untrusted => occluded
    )


def _insert_potential(state: GrowState, n) -> GrowState:
    """insert_potential_candidates (:813-846) + prepare_data_for_growing
    (:860-870): survivors become the new queue; everything else resets."""
    ok = jnp.isfinite(state.out_u) & jnp.isfinite(state.out_v)
    return state._replace(
        cand_u=jnp.where(ok, state.out_u, 0.0),
        cand_v=jnp.where(ok, state.out_v, 0.0),
        cand_e=jnp.where(ok, state.ene, jnp.inf),
        fixed=jnp.zeros_like(state.fixed),
        ene=jnp.full_like(state.ene, jnp.inf),
        out_u=jnp.full_like(state.out_u, jnp.nan),
        out_v=jnp.full_like(state.out_v, jnp.nan),
    )


def _warm_requeue(state: GrowState, trust, n, h, w, band) -> GrowState:
    """Warm drain requeue: trusted pixels farther than ``band`` px from any
    pruned hole stay FIXED with their flow/energy; trusted pixels inside the
    band re-queue as candidates (their re-solves grow into the holes and
    seed them via the usual neighbour scatters).

    The reference re-grows the whole image every outer iteration
    (insert_potential_candidates + prepare_data_for_growing,
    local_faldoi.cpp:813-870): every trusted pixel re-pops and re-solves,
    and far from any pruned region that re-solve reproduces the same flow —
    pure drain cost.  Keeping those pixels fixed makes the drain's sweep
    count scale with the pruned area (a few % after iteration 0) instead of
    the image.  Output equivalence at the band edge is by the same argument
    as the serial pop order: a fixed pixel's value only feeds neighbours as
    a donation, exactly as if it had re-popped first.

    ``trust``/state arrays may carry leading lane axes (the paired fwd/bwd
    drain stacks (2, N+1)); the hole dilation runs on the trailing (h, w)
    grid per lane."""
    lead = trust.shape[:-1]
    bad2d = (trust[..., :n] == 0).reshape(lead + (h, w))

    def _shift(x, s, ax):
        # non-wrapping shift (jnp.roll wrapped the
        # dilation across the image edge, re-queueing far-edge pixels
        # whenever a hole sat near the opposite edge)
        nax = x.ndim + ax
        pw = [(0, 0)] * x.ndim
        pw[nax] = (max(s, 0), max(-s, 0))
        xp = jnp.pad(x, pw)
        idx = [slice(None)] * x.ndim
        size = x.shape[nax]
        idx[nax] = slice(max(-s, 0), max(-s, 0) + size)
        return xp[tuple(idx)]

    near = bad2d
    for ax in (-2, -1):
        acc = near
        # separable box dilation by ``band``
        for s in range(1, band + 1):
            acc = acc | _shift(near, s, ax) | _shift(near, -s, ax)
        near = acc
    pad1 = jnp.zeros(lead + (1,), bool)
    near = jnp.concatenate([near.reshape(lead + (n,)), pad1], axis=-1)
    bad = jnp.concatenate([bad2d.reshape(lead + (n,)), pad1], axis=-1)
    ok = ~bad & jnp.isfinite(state.out_u) & jnp.isfinite(state.out_v)
    requeue = ok & near
    keep = ok & ~near
    nanv = jnp.where(bad, jnp.nan, 0.0)
    return state._replace(
        cand_u=jnp.where(requeue, state.out_u, 0.0),
        cand_v=jnp.where(requeue, state.out_v, 0.0),
        cand_e=jnp.where(requeue, state.ene, jnp.inf),
        fixed=keep,
        ene=jnp.where(keep, state.ene, jnp.inf),
        out_u=jnp.where(keep, state.out_u, jnp.nan),
        out_v=jnp.where(keep, state.out_v, jnp.nan),
        wu=state.wu + nanv,   # NaN-poison untrusted working flow (as cold)
        wv=state.wv + nanv,
        out_chi=jnp.where(bad, 1.0, state.out_chi),
    )


@functools.partial(
    jax.jit, static_argnames=("n", "h", "w", "warm_band"))
def _prune_requeue_pair(st2, i0n, i1n, epsilon, *, n, h, w, warm_band):
    """One program for the whole inter-iteration step on the paired state:
    extract fwd/bwd flows, FB-prune, rebuild the trust planes, requeue.

    Fusing this matters for process warmup, not steady-state speed: run
    eagerly, the requeue's dilation/masking glue compiles ~80 tiny
    single-op programs."""
    fwd = jnp.stack([st2.out_u[0, :n].reshape(h, w),
                     st2.out_v[0, :n].reshape(h, w)], axis=-1)
    bwd = jnp.stack([st2.out_u[1, :n].reshape(h, w),
                     st2.out_v[1, :n].reshape(h, w)], axis=-1)
    tg, tb = prune(i0n, i1n, fwd, bwd, epsilon)
    trust2 = jnp.concatenate(
        [jnp.stack([tg.reshape(-1), tb.reshape(-1)]),
         jnp.ones((2, 1), jnp.int32)], axis=1,
    )
    if warm_band:
        st2 = _warm_requeue(st2, trust2, n, h, w, warm_band)
    else:
        st2 = _insert_potential(_delete_untrusted(st2, trust2, n), n)
    return st2, trust2, tg, tb


@functools.partial(
    jax.jit, static_argnames=("npairs", "n", "h", "w", "warm_band"))
def _prune_requeue_pairs(st2, i0s, i1s, epsilon, *, npairs, n, h, w,
                         warm_band):
    """``_prune_requeue_pair`` generalised to N pairs stacked as 2N lanes
    [fwd0..fwdN-1, bwd0..bwdN-1]: per-pair FB pruning (vmapped over the
    pair axis), trust rebuild and requeue in one program."""
    np_ = npairs
    fwd = jnp.stack([st2.out_u[:np_, :n].reshape(np_, h, w),
                     st2.out_v[:np_, :n].reshape(np_, h, w)], axis=-1)
    bwd = jnp.stack([st2.out_u[np_:, :n].reshape(np_, h, w),
                     st2.out_v[np_:, :n].reshape(np_, h, w)], axis=-1)
    tg, tb = jax.vmap(
        lambda a, b, f, g: prune(a, b, f, g, epsilon)
    )(i0s, i1s, fwd, bwd)
    trust2 = jnp.concatenate([
        jnp.concatenate([tg.reshape(np_, n), tb.reshape(np_, n)], axis=0),
        jnp.ones((2 * np_, 1), jnp.int32)], axis=1)
    if warm_band:
        st2 = _warm_requeue(st2, trust2, n, h, w, warm_band)
    else:
        st2 = _insert_potential(_delete_untrusted(st2, trust2, n), n)
    return st2, trust2, tg, tb


def match_growing_pairs(
    seeds_pairs,        # list of (go, ba): (h, w, 2) NaN-sparse seed fields
    frames_pairs,       # list of (i0n, i1n): normalized/smoothed frames
    prm: P.Parameters,
    bsz: int = 8192,
    verbose: bool = False,
    delta: float = 0.05,
    fill: str = "patch",
    floor: Optional[int] = None,
    relax: bool = False,
    delta_rel: float = 0.5,
    floor_scale: int = 64,
):
    """Grow N frame pairs CONCURRENTLY as 2N unrolled lanes per sweep
    program — the throughput mode.

    Stacking N independent pairs as 2N lanes in ONE sweep program shares
    every dispatch and host sync among N pairs; per-lane ``lax.cond``
    gating (grow_chunk_pair) keeps mixed-difficulty batches from paying
    the slowest pair's sweep count on every lane.  Lanes are independent,
    so per-pair results are identical to N separate ``match_growing``
    calls at the same dials (modulo the shared rung-adaptation schedule,
    which only affects top-k truncation — parity-safe).

    Returns a list of (flow (h,w,2), energy (h,w), occ (h,w)) per pair.
    Reference envelope: the IPOL cluster processes pairs serially at
    ~55-120 s/pair (scripts_python/README.txt:125-129).
    """
    npairs = len(seeds_pairs)
    assert npairs >= 1 and len(frames_pairs) == npairs
    assert prm.val_method != P.M_TVL1_OCC, (
        "pairs mode supports the 2-frame methods; run method 8 per-pair")
    if floor is None and os.environ.get("FALDOI_GROW_FLOOR"):
        floor = int(os.environ["FALDOI_GROW_FLOOR"])
    if floor is None and not relax:
        floor = 4096  # dense-phase rank floor (see match_growing)
    if os.environ.get("FALDOI_GROW_DELTA"):
        delta = float(os.environ["FALDOI_GROW_DELTA"])
    if os.environ.get("FALDOI_GROW_DELTA_REL"):
        delta_rel = float(os.environ["FALDOI_GROW_DELTA_REL"])
    if os.environ.get("FALDOI_GROW_FLOOR_SCALE"):
        floor_scale = int(os.environ["FALDOI_GROW_FLOOR_SCALE"])
    if os.environ.get("FALDOI_GROW_BSZ"):
        bsz = int(os.environ["FALDOI_GROW_BSZ"])
    fill = os.environ.get("FALDOI_GROW_FILL", fill)
    if fill == "patch" and prm.val_method not in (
        P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W
    ):
        fill = "patch_rb"
    elif fill == "patch_exact":
        fill = "patch"

    h, w = frames_pairs[0][0].shape
    n = h * w
    lam, theta, tau = method_local_params(prm.val_method, prm.w_radio)
    p = 2 * prm.w_radio + 1
    solver = SOLVERS[prm.val_method]

    sc_go_l, sc_ba_l = [], []
    for i0n, i1n in frames_pairs:
        assert i0n.shape == (h, w), "pairs must share the frame geometry"
        if prm.val_method in _CONSTS_JIT_METHODS:
            sc_go, sc_ba = _consts_pair_jit(
                prm.val_method, i0n, i1n, lam, theta, tau, prm.tol_OF,
                prm.w_radio, p)
        else:
            i0x, i0y = centered_gradient(i0n)
            i1x, i1y = centered_gradient(i1n)
            sc_go = make_solver_consts(
                prm.val_method, pad_for_crops(i0n, p), i1n, i1x, i1y,
                lam, theta, tau, prm.tol_OF, wr=prm.w_radio, p=p)
            sc_ba = make_solver_consts(
                prm.val_method, pad_for_crops(i1n, p), i0n, i0x, i0y,
                lam, theta, tau, prm.tol_OF, wr=prm.w_radio, p=p)
        sc_go_l.append(sc_go)
        sc_ba_l.append(sc_ba)
    # lane order [fwd0..fwdN-1, bwd0..bwdN-1]: the final forward-only
    # growing drains the first npairs lanes
    sc2 = _stack_trees(*(sc_go_l + sc_ba_l))

    pd_cap = prm.max_iter_patch
    ls = LocalSolver(
        h, w, wr=prm.w_radio, bsz=bsz, solver=solver,
        warps=prm.warps, max_iters=max(pd_cap, 1),
        mode="chunked", delta=delta,
        chunk=int(os.environ.get("FALDOI_GROW_CHUNK", "64")),
        fill=fill, floor=floor, relax=relax, delta_rel=delta_rel,
        floor_scale=floor_scale, with_chi=False,
    )

    sal = jnp.ones((n + 1,), jnp.float32)
    states = []
    for k in range(2):            # 0: fwd lanes, 1: bwd lanes
        for pi in range(npairs):
            go, ba = seeds_pairs[pi]
            seeds = go if k == 0 else ba
            sc = (sc_go_l if k == 0 else sc_ba_l)[pi]
            states.append(ls.insert_seeds(init_state(h, w), seeds, sc, sal))
    st2 = _stack_trees(*states)
    sal2 = jnp.broadcast_to(sal, (2 * npairs, n + 1))
    trust2 = jnp.ones((2 * npairs, n + 1), jnp.int32)
    i0s = jnp.stack([f[0] for f in frames_pairs])
    i1s = jnp.stack([f[1] for f in frames_pairs])

    fs_late = int(os.environ.get("FALDOI_GROW_FS_LATE", "0")) or min(
        floor_scale, 16)
    warm_band = int(os.environ.get("FALDOI_GROW_WARM_BAND", "10"))
    relax_late = os.environ.get("FALDOI_GROW_RELAX_LATE", "0") == "1"

    import time

    t = time.time()
    for it in range(prm.iterations_of):
        ls.floor_scale = floor_scale if it == 0 else fs_late
        ls.relax = relax or (relax_late and it >= 1)
        st2 = ls.grow_pair(st2, sc2, trust2, sal2, it)
        if verbose:
            jax.block_until_ready(st2)
            print(f"(pairs) growings it={it} (<= {ls.last_sweeps} sweeps): "
                  f"{time.time() - t:.2f}s")
            t = time.time()
        st2, trust2, _tg, _tb = _prune_requeue_pairs(
            st2, i0s, i1s, jnp.float32(prm.epsilon),
            npairs=npairs, n=n, h=h, w=w, warm_band=warm_band,
        )

    ls.floor_scale = fs_late
    ls.relax = relax or relax_late
    ls.lanes = npairs          # final growing: forward lanes only
    st2 = ls.grow_pair(st2, sc2, trust2, sal2, prm.iterations_of)
    ls.lanes = None
    LocalSolver.cancel_prewarm()
    jax.block_until_ready(st2)
    if verbose:
        print(f"(pairs) final growing: {time.time() - t:.2f}s")

    outs = []
    for pi in range(npairs):
        st = jax.tree.map(lambda a: a[pi], st2)
        flow = _flow2d(st, h, w)
        ene = np.asarray(st.ene[:n]).reshape(h, w)
        occ = np.asarray(st.out_chi[:n]).reshape(h, w)
        outs.append((flow, ene, occ))
    return outs


@functools.partial(jax.jit, static_argnames=("h", "w"))
def _flow_dev(state: GrowState, h, w):
    n = h * w
    return jnp.stack([state.out_u[:n].reshape(h, w),
                      state.out_v[:n].reshape(h, w)], axis=-1)


def _flow2d(state: GrowState, h, w):
    # one program + one fetch (the eager slice/reshape pair compiled two
    # single-op programs and fetched twice)
    return np.asarray(_flow_dev(state, h, w))


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver", "iterations", "h", "w", "wr", "bsz", "warps", "max_iters",
        "fill", "relax", "block", "with_chi", "warm_band",
    ),
)
def _iterated_growing(
    st_go: GrowState, st_ba: GrowState, sc_go, sc_ba, sal_g, sal_b,
    i0n, i1n, epsilon,
    solver, iterations: int,
    h: int, w: int, wr: int, bsz: int, warps: int, max_iters: int,
    delta: float, fill: str, floor, relax: bool, relax_margin: float,
    delta_rel: float = 0.0, floor_scale: int = 0, block: int = 0,
    with_chi: bool = True, floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
    floor_scale_late=None, warm_band: int = 0,
):
    """The ENTIRE post-seed local step as ONE device program: per outer
    iteration {fwd drain, bwd drain, FB prune, delete+requeue}, then the
    final forward-only drain (local_faldoi.cpp:1184-1712).  One launch and
    one result fetch: no host sync between sweeps.
    """
    from faldoi_tpu.core.local_step import _sweep_body

    n = h * w
    if floor_scale_late is None:
        floor_scale_late = floor_scale

    # P1 (fwd/bwd OpenMP task pair, local_faldoi.cpp:1130-1139,1191-1219)
    # as a DEVICE BATCH: both directions' states are stacked on a leading
    # axis of size 2 and every sweep solves both directions' patch batches
    # at once (vmapped _sweep_body).  The lockstep while_loop runs until
    # both queues drain; a drained lane's sweeps are no-ops (empty top-k).
    st2 = jax.tree.map(lambda a, b: jnp.stack([a, b]), st_go, st_ba)
    sc2 = jax.tree.map(lambda a, b: jnp.stack([a, b]), sc_go, sc_ba)
    sal2 = jnp.stack([sal_g, sal_b])

    def sweep_pair(s2, sc2_, tr2, sal2_, it, fs, lanes=2):
        # unrolled lanes, not vmap (see local_step.grow_chunk_pair)
        outs, accs = [], []
        for lane in range(lanes):
            s_l = jax.tree.map(lambda a: a[lane], s2)
            sc_l = jax.tree.map(lambda a: a[lane], sc2_)
            s_l, acc = _sweep_body(
                s_l, solver, sc_l, tr2[lane], sal2_[lane], it,
                h, w, wr, bsz, warps, max_iters,
                delta=delta, fill=fill, floor=floor, relax=relax,
                relax_margin=relax_margin, delta_rel=delta_rel,
                floor_scale=fs, block=block, with_chi=with_chi,
                floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
            )
            outs.append(s_l)
            accs.append(acc)
        if lanes == 1:
            outs.append(jax.tree.map(lambda a: a[1], s2))
            accs.append(jnp.asarray(0, accs[0].dtype))
        s2n = jax.tree.map(lambda a, b: jnp.stack([a, b]), outs[0], outs[1])
        return s2n, jnp.stack(accs)

    def drain_pair(st2, trust2, it, fs, lanes=2):
        trust2d = trust2[:, :n].reshape(2, h, w).astype(jnp.float32)

        def cond(carry):
            _, n_acc, _ = carry
            return n_acc.sum() > 0

        def body(carry):
            s, _, k = carry
            s, acc = sweep_pair(s, sc2, trust2d, sal2, it, fs, lanes)
            return (s, acc, k + 1)

        st2, _, k = jax.lax.while_loop(
            cond, body,
            (st2, jnp.ones((2,), jnp.int32), jnp.asarray(0, jnp.int32)),
        )
        return st2, k

    trust_init = jnp.ones((2, n + 1), jnp.int32)
    ones21 = jnp.ones((2, 1), jnp.int32)

    def one_iter(it, carry):
        st2, trust2, sw = carry
        # per-phase ordering throttle (same rule as the chunked path):
        # iteration 0 keeps the tight parity floor; requeue drains use the
        # looser late-phase scale
        fs = jnp.where(it == 0, jnp.asarray(floor_scale, jnp.int32),
                       jnp.asarray(floor_scale_late, jnp.int32))
        st2, k = drain_pair(st2, trust2, it, fs)
        fwd = jnp.stack(
            [st2.out_u[0, :n].reshape(h, w), st2.out_v[0, :n].reshape(h, w)],
            axis=-1,
        )
        bwd = jnp.stack(
            [st2.out_u[1, :n].reshape(h, w), st2.out_v[1, :n].reshape(h, w)],
            axis=-1,
        )
        tg, tb = prune(i0n, i1n, fwd, bwd, epsilon)
        trust2 = jnp.concatenate(
            [jnp.stack([tg.reshape(-1), tb.reshape(-1)]), ones21], axis=1
        )
        # _delete_untrusted/_insert_potential/_warm_requeue are elementwise
        # (plus a per-lane roll dilation) over the flat state arrays, so
        # they apply to the stacked (2, n+1) lanes directly; warm matches
        # the chunked path's default (mode equivalence).
        if warm_band:
            st2 = _warm_requeue(st2, trust2, n, h, w, warm_band)
        else:
            st2 = _insert_potential(_delete_untrusted(st2, trust2, n), n)
        return (st2, trust2, sw + k)

    carry = (st2, trust_init, jnp.asarray(0, jnp.int32))
    st2, trust2, sweeps = jax.lax.fori_loop(0, iterations, one_iter, carry)
    # final FORWARD-ONLY growing (local_faldoi.cpp:1636-1712): only the fwd
    # lane sweeps (lanes=1; the bwd lane's state is carried untouched).
    # The final drain always uses the late-phase floor scale (as chunked).
    st2, k = drain_pair(st2, trust2, jnp.asarray(iterations, jnp.int32),
                        jnp.asarray(floor_scale_late, jnp.int32), lanes=1)
    st_go = jax.tree.map(lambda a: a[0], st2)
    return st_go, sweeps + k


def match_growing(
    go: np.ndarray,              # (h, w, 2) forward seeds (NaN-sparse)
    ba: np.ndarray,              # (h, w, 2) backward seeds
    i0n: jnp.ndarray,            # normalized/smoothed frames
    i1n: jnp.ndarray,
    prm: P.Parameters,
    sal_go: Optional[np.ndarray] = None,
    sal_ba: Optional[np.ndarray] = None,
    i0_planes: Optional[np.ndarray] = None,
    i1_planes: Optional[np.ndarray] = None,
    i_1n: Optional[jnp.ndarray] = None,   # method 8: frame t-1
    i2n: Optional[jnp.ndarray] = None,    # method 8: frame t+2
    bsz: int = 4096,
    verbose: bool = False,
    mode: str = "fused",
    delta: float = 0.05,
    chunk: int = 64,
    fused=None,
    fill: str = "patch",
    floor: Optional[int] = None,
    relax: bool = False,
    bilateral: bool = False,
    delta_rel: float = 0.5,
    floor_scale: int = 64,
    block: int = 0,
    floor_scale_hi: int = 0,
    queue_hi: int = 1 << 30,
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    # Defaults validated against the reference binaries on the seed-sparse
    # 192x256 crop (the adversarial fixture for wavefront ordering): patch
    # fill + a tight delta band + floor_scale=64 give var EPE 0.0257 vs the
    # binaries (gate 0.05) where any whole-image fill or constant rank
    # floor diverges by >1 px.  See scripts/run_parity.py and PARITY.md.
    # delta=0.05 (not 0.01): the full-scale re-sweep measured 0.05
    # strictly better in parity (rg 0.2520 / var 0.0089 vs 0.2623 /
    # 0.0096); the absolute band only binds in near-zero-energy phases
    # (elsewhere the relative band 0.5*e_min dominates, making 0.01 vs
    # 0.02 bit-identical).
    """Returns (flow (h,w,2), energy (h,w), occlusion (h,w)) for the
    forward direction.  ``stats``, when given, receives the sweep count
    under "sweeps" (in chunked mode an upper bound: whole chunks)."""
    if stats is None:
        stats = {}
    # "fused" (the whole iterated growing as one program) is the default:
    # on the H100 it measured faster than "chunked" both warm and cold
    # (PERF.md).  Chunked drains serve partial-result snapshots and the
    # pairs mode.
    mode = os.environ.get("FALDOI_GROW_MODE", mode)
    if floor is None and os.environ.get("FALDOI_GROW_FLOOR"):
        floor = int(os.environ["FALDOI_GROW_FLOOR"])
    if floor is None and not relax:
        # dense-phase rank floor: floor_dyn = min(floor, queue//floor_scale)
        # only binds once the queue exceeds floor*floor_scale (262k at the
        # defaults) — i.e. the requeue phases of full frames, where flooding
        # is parity-safe (measured full-scale: var EPE 0.0272 at floor 4096
        # vs 0.0275 at 512; the sparse-crop validation is untouched because
        # small-queue behaviour is identical).
        floor = 4096
    if os.environ.get("FALDOI_GROW_DELTA"):
        delta = float(os.environ["FALDOI_GROW_DELTA"])
    if os.environ.get("FALDOI_GROW_DELTA_REL"):
        delta_rel = float(os.environ["FALDOI_GROW_DELTA_REL"])
    if os.environ.get("FALDOI_GROW_FLOOR_SCALE"):
        floor_scale = int(os.environ["FALDOI_GROW_FLOOR_SCALE"])
    if os.environ.get("FALDOI_GROW_BLOCK"):
        block = int(os.environ["FALDOI_GROW_BLOCK"])
    if os.environ.get("FALDOI_GROW_FS_HI"):
        floor_scale_hi = int(os.environ["FALDOI_GROW_FS_HI"])
    if os.environ.get("FALDOI_GROW_QHI"):
        queue_hi = int(os.environ["FALDOI_GROW_QHI"])
    if os.environ.get("FALDOI_GROW_BSZ"):
        bsz = int(os.environ["FALDOI_GROW_BSZ"])
    if os.environ.get("FALDOI_GROW_CHUNK"):
        chunk = int(os.environ["FALDOI_GROW_CHUNK"])
    fill = os.environ.get("FALDOI_GROW_FILL", fill)
    if fill == "patch" and prm.val_method not in (
        P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W
    ):
        # method-dependent fill exactness: only the inert-TV CSAD family
        # passes the Poisson init through to its output; everyone else is
        # parity-validated with the ~10x cheaper red-black relaxation
        # (pass fill="patch_exact"/FALDOI_FILL_EXACT=1 to force raster GS)
        fill = "patch_rb"
    elif fill == "patch_exact":
        fill = "patch"
    h, w = i0n.shape
    n = h * w
    lam, theta, tau = method_local_params(prm.val_method, prm.w_radio)
    p = 2 * prm.w_radio + 1

    solver = SOLVERS[prm.val_method]
    # fwd: source I0, warp I1; bwd: source I1, warp I0
    if prm.val_method in _CONSTS_JIT_METHODS:
        sc_go, sc_ba = _consts_pair_jit(
            prm.val_method, i0n, i1n, lam, theta, tau, prm.tol_OF,
            prm.w_radio, p)
    else:
        i0x, i0y = centered_gradient(i0n)
        i1x, i1y = centered_gradient(i1n)
        sc_go = make_solver_consts(
            prm.val_method, pad_for_crops(i0n, p), i1n, i1x, i1y,
            lam, theta, tau, prm.tol_OF, wr=prm.w_radio,
            i0_planes=i0_planes, p=p,
        )
        sc_ba = make_solver_consts(
            prm.val_method, pad_for_crops(i1n, p), i0n, i0x, i0y,
            lam, theta, tau, prm.tol_OF, wr=prm.w_radio,
            i0_planes=i1_planes, p=p,
        )
    if prm.val_method == P.M_TVL1_OCC:
        # 4-frame occlusion setup (energy_model.cpp:609-658): the fwd
        # direction warps I1 forward and I-1 backward; the bwd direction
        # warps I0 forward and I2 backward; g = 1/(1+gamma|grad src|).
        from faldoi_tpu.core.occlusion import init_weight

        assert i_1n is not None and i2n is not None, "method 8 needs 4 frames"
        i_1x, i_1y = centered_gradient(i_1n)
        i2x, i2y = centered_gradient(i2n)
        occ_prm = jnp.asarray(
            [prm.alpha, prm.beta, prm.mu, prm.tau_u, prm.tau_eta, prm.tau_chi],
            jnp.float32,
        )
        g_go = init_weight(i0x, i0y)
        g_ba = init_weight(i1x, i1y)
        gpad_go = pad_for_crops(g_go, p)
        gpad_ba = pad_for_crops(g_ba, p)
        sc_go = sc_go._replace(
            i_1=i_1n, i_1x=i_1x, i_1y=i_1y, gpad=gpad_go, occ_prm=occ_prm,
        )
        sc_ba = sc_ba._replace(
            i_1=i2n, i_1x=i2x, i_1y=i2y, gpad=gpad_ba, occ_prm=occ_prm,
        )

    def mksal(s):
        base = np.ones(n + 1, np.float32)
        if s is not None:
            base[:n] = np.asarray(s, np.float32).ravel()
        return jnp.asarray(base)

    sal_g = mksal(sal_go)
    sal_b = mksal(sal_ba)

    # the occ solver's PD cap is iterations_of, not max_iter_patch
    # (tvl2_model_occ.cpp:653 reads ofD->params.iterations_of)
    pd_cap = (prm.iterations_of if prm.val_method == P.M_TVL1_OCC
              else prm.max_iter_patch)
    # chi (occlusion) state only flows for method 8 — skipping its scatter
    # and crop channels saves ~15% of the sweep cost for everyone else
    with_chi = prm.val_method == P.M_TVL1_OCC
    ls = LocalSolver(
        h, w, wr=prm.w_radio, bsz=bsz, solver=solver,
        warps=prm.warps, max_iters=max(pd_cap, 1),
        mode=mode, delta=delta, chunk=chunk, fused=fused, fill=fill,
        floor=floor, relax=relax, delta_rel=delta_rel,
        floor_scale=floor_scale, block=block, with_chi=with_chi,
        floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
    )

    import time

    import jax

    def tick(label, t0):
        if verbose:
            print(f"(match_growing) {label}: {time.time() - t0:.2f}s")
        return time.time()

    t = time.time()
    st_go = init_state(h, w)
    st_ba = init_state(h, w)
    st_go = ls.insert_seeds(st_go, go, sc_go, sal_g)
    st_ba = ls.insert_seeds(st_ba, ba, sc_ba, sal_b)
    if verbose:
        jax.block_until_ready(st_go)
    t = tick("seed insertion", t)

    trust_all = jnp.ones((n + 1,), jnp.int32)
    trust_go, trust_ba = trust_all, trust_all

    # Per-phase ordering throttle: iteration 0 grows from sparse seeds,
    # where the serial pop order decides which front claims territory —
    # keep the tight queue-adaptive floor there.  The requeue drains
    # (iterations >= 1 and the final growing) start from a ~93-98%-correct
    # dense field, so a looser floor_scale there cuts their sweep count
    # with little ordering consequence.  Measured full-scale: fs_late=16
    # keeps var EPE at 0.0289 (0.0277 at 64); fs_late=8 degrades rg enough
    # (0.56) that the global step's tol loop blows up — 16 is the knee.
    fs_late = int(os.environ.get("FALDOI_GROW_FS_LATE", "0")) or min(
        floor_scale, 16)
    # Warm drains: re-queue only a band around pruned holes, keep the rest
    # of the trusted field fixed (see _warm_requeue).  0 = cold (reference
    # semantics: full re-grow each iteration).  Default 10 px, measured
    # full-scale: var EPE 0.0276 -> 0.0293 (gate 0.05), rg 0.456 -> 0.517,
    # for a sweep count that scales with the pruned area.
    warm_band = int(os.environ.get("FALDOI_GROW_WARM_BAND", "10"))
    # REQUEUE ARBITRATION (r4, rg-tail mechanism (b), PARITY.md deviation
    # #1): in the serial heap the re-queued survivors and the invading
    # fronts' candidates share ONE global energy order — a survivor with
    # stored energy e only pops after every front whose candidates are
    # below e has swept through, so lower-energy invaders OVERRIDE
    # post-prune survivors (local_faldoi.cpp:813-870 + 891-1039).  The
    # batched drains' rank floor accepts survivors en masse long before an
    # invading front can physically arrive.  FALDOI_GROW_RELAX_LATE=1 runs
    # the requeue iterations (>= 1 and the final drain) in label-correcting
    # relax mode: survivors still fix early, but a strictly-lower-energy
    # claim arriving later RE-POPS the pixel — converging to the same
    # "lowest energy claim wins" arbitration as the serial queue without
    # its global ordering.  Iteration 0 keeps strict mode (relax there was
    # measured to degrade the seed-growth phase).
    relax_late = os.environ.get("FALDOI_GROW_RELAX_LATE", "0") == "1"

    def _requeue(st, tr):
        if warm_band:
            return _warm_requeue(st, tr, n, h, w, warm_band)
        return _insert_potential(_delete_untrusted(st, tr, n), n)

    # Polish passes after each drain (core.local_step.polish_all): re-solve
    # every pixel's patch from the evolved field — the batch form of the
    # re-solves that warm drains skip.  0 = off.
    polish_k = int(os.environ.get("FALDOI_GROW_POLISH", "0"))

    def _polish_pair(st2_, sc2_, sal2_):
        from faldoi_tpu.core.local_step import polish_all

        pol = jax.vmap(lambda s, sc, sl: polish_all(
            s, sc, sl, solver, h, w, prm.w_radio, ls.bsz,
            prm.warps, max(pd_cap, 1), with_chi=with_chi))
        for _ in range(polish_k):
            st2_ = pol(st2_, sc2_, sal2_)
        return st2_

    if mode == "fused" and not prm.part_res and not bilateral:
        # single-program path: the whole iterated growing in one launch
        st_go, sweeps = _iterated_growing(
            st_go, st_ba, sc_go, sc_ba, sal_g, sal_b,
            i0n, i1n, jnp.asarray(prm.epsilon, jnp.float32),
            solver, prm.iterations_of,
            h, w, prm.w_radio, ls.bsz, prm.warps, max(pd_cap, 1),
            delta, fill, ls.floor, relax, ls.relax_margin, delta_rel,
            floor_scale, block, with_chi, floor_scale_hi, queue_hi,
            floor_scale_late=fs_late, warm_band=warm_band,
        )
        stats["sweeps"] = int(sweeps)
        if verbose:
            t = tick(f"iterated growing (one program, {int(sweeps)} sweeps)", t)
        flow = _flow2d(st_go, h, w)
        ene = np.asarray(st_go.ene[:n]).reshape(h, w)
        occ = np.asarray(st_go.out_chi[:n]).reshape(h, w)
        return flow, ene, occ

    snapshot_cb = None
    if prm.part_res:
        import faldoi_tpu.io as fio

        os.makedirs("partial_results", exist_ok=True)
        marks = {}

        def snapshot_cb(state, frac, _marks=marks):
            # reference thresholds (local_faldoi.cpp:895): 30/70/80/95%
            it = _marks.get("it", 0)
            for pct in (30, 70, 80, 95):
                key = (it, pct)
                if frac * 100 >= pct and key not in _marks:
                    _marks[key] = True
                    fio.write_flo(
                        f"partial_results/partial_fwd_{pct}_iter_{it}.flo",
                        _flow2d(state, h, w),
                    )

    def _bfill(st, tr2d):
        # optional bilateral pre-fill of the untrusted working flow
        # (the reference's dormant bilateral_filter hook,
        # local_faldoi.cpp:701-702; see core/bilateral.py)
        from faldoi_tpu.core.bilateral import bilateral_filter_flow

        zeros2d = jnp.zeros((h, w), jnp.int32)
        bu, bv = bilateral_filter_flow(
            i0n,
            jnp.nan_to_num(st.wu[:n].reshape(h, w)),
            jnp.nan_to_num(st.wv[:n].reshape(h, w)),
            tr2d, zeros2d,
        )
        pad1 = st.wu[n:]
        return st._replace(
            wu=jnp.concatenate([bu.ravel(), pad1]),
            wv=jnp.concatenate([bv.ravel(), pad1]),
        )

    if mode == "chunked":
        # P1 paired drain: both directions as one stacked device batch per
        # sweep (see LocalSolver.grow_pair); prune/requeue stay on device.
        st2 = _stack_trees(st_go, st_ba)
        sc2 = _stack_trees(sc_go, sc_ba)
        sal2 = jnp.stack([sal_g, sal_b])
        trust2 = jnp.ones((2, n + 1), jnp.int32)
        stats["sweeps"] = 0
        for it in range(prm.iterations_of):
            if snapshot_cb is not None:
                marks["it"] = it
            ls.floor_scale = floor_scale if it == 0 else fs_late
            ls.relax = relax or (relax_late and it >= 1)
            st2 = ls.grow_pair(st2, sc2, trust2, sal2, it,
                               snapshot_cb=snapshot_cb)
            stats["sweeps"] += ls.last_sweeps
            if polish_k and it >= 1:
                # the reference's iteration-(>=1) growings re-solve every
                # pixel; warm drains skip that outside the hole bands —
                # polish restores it in batch form
                st2 = _polish_pair(st2, sc2, sal2)
            t = tick(f"growings it={it} (paired, <= {ls.last_sweeps} sweeps)",
                     t)
            st2, trust2, tg, tb = _prune_requeue_pair(
                st2, i0n, i1n, jnp.float32(prm.epsilon),
                n=n, h=h, w=w, warm_band=warm_band,
            )
            if verbose:
                print(
                    f"iter {it}: FB-chosen fwd {float(tg.mean()):.3f} "
                    f"bwd {float(tb.mean()):.3f}"
                )
            if bilateral:
                st_go = _bfill(jax.tree.map(lambda a: a[0], st2), tg)
                st_ba = _bfill(jax.tree.map(lambda a: a[1], st2), tb)
                st2 = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                                   st_go, st_ba)
            t = tick(f"prune+requeue it={it}", t)

        # final forward-only growing (local_faldoi.cpp:1636-1712); the bwd
        # lane drains alongside in lockstep (discarded)
        if snapshot_cb is not None:
            marks["it"] = prm.iterations_of
        ls.floor_scale = fs_late
        ls.relax = relax or relax_late
        # the final growing is forward-only (local_faldoi.cpp:1636-1712):
        # drain just the fwd lane (half the sweep cost; the bwd lane's
        # state is carried through untouched and discarded)
        ls.lanes = 1
        st2 = ls.grow_pair(st2, sc2, trust2, sal2, prm.iterations_of,
                           snapshot_cb=snapshot_cb)
        stats["sweeps"] += ls.last_sweeps
        ls.lanes = None
        LocalSolver.cancel_prewarm()
        if polish_k:
            st2 = _polish_pair(st2, sc2, sal2)
        st_go = jax.tree.map(lambda a: a[0], st2)
        jax.block_until_ready(st_go)
        t = tick("final growing", t)

        flow = _flow2d(st_go, h, w)
        ene = np.asarray(st_go.ene[:n]).reshape(h, w)
        occ = np.asarray(st_go.out_chi[:n]).reshape(h, w)
        return flow, ene, occ

    for it in range(prm.iterations_of):
        if snapshot_cb is not None:
            marks["it"] = it
        ls.floor_scale = floor_scale if it == 0 else fs_late
        st_go = ls.grow(st_go, sc_go, trust_go, sal_g, it,
                        snapshot_cb=snapshot_cb)
        sw_go = ls.last_sweeps
        st_ba = ls.grow(st_ba, sc_ba, trust_ba, sal_b, it)
        jax.block_until_ready(st_ba)
        t = tick(f"growings it={it} (sweeps fwd={sw_go} bwd={ls.last_sweeps})", t)

        fwd = _flow2d(st_go, h, w)
        bwd = _flow2d(st_ba, h, w)
        tg, tb = prune(
            i0n, i1n, jnp.asarray(fwd), jnp.asarray(bwd), prm.epsilon
        )
        if verbose:
            print(
                f"iter {it}: FB-chosen fwd {float(tg.mean()):.3f} "
                f"bwd {float(tb.mean()):.3f}"
            )
        trust_go = jnp.concatenate([tg.ravel(), jnp.ones((1,), jnp.int32)])
        trust_ba = jnp.concatenate([tb.ravel(), jnp.ones((1,), jnp.int32)])

        st_go = _requeue(st_go, trust_go)
        st_ba = _requeue(st_ba, trust_ba)
        if bilateral:
            st_go = _bfill(st_go, tg)
            st_ba = _bfill(st_ba, tb)
        t = tick(f"prune+requeue it={it}", t)

    # final forward-only growing (local_faldoi.cpp:1636-1712)
    if snapshot_cb is not None:
        marks["it"] = prm.iterations_of
    ls.floor_scale = fs_late
    st_go = ls.grow(st_go, sc_go, trust_go, sal_g, prm.iterations_of,
                    snapshot_cb=snapshot_cb)
    jax.block_until_ready(st_go)
    t = tick("final growing", t)

    flow = _flow2d(st_go, h, w)
    ene = np.asarray(st_go.ene[:n]).reshape(h, w)
    occ = np.asarray(st_go.out_chi[:n]).reshape(h, w)
    return flow, ene, occ

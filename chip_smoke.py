#!/usr/bin/env python
"""Smoke run of the FALDOI pipeline on one GPU, at Sintel shape.

    python chip_smoke.py                 # phases a-e on one GPU
    python chip_smoke.py --ab PARENT     # timed A/B runs (see ab_runs)

Phases, each printed with its wall time and the card's name and power
limit:

a. the device, the JAX version, XLA_FLAGS and the card;
b. every kernel of the local and global steps at production width against
   a NumPy reference: the sweep's patch crop (bit-exact), the patch warp,
   the whole-image warp and the candidate selection;
c. the library path ``prepare_pair -> match_growing -> tvl2_global`` with
   default arguments on the seeded 436x1024 pair (faldoi_tpu.synthetic),
   cold, then warm twice;
d. the same program on a 160x160 crop on the GPU and on the CPU backend;
e. the CLI drivers ``sparse_flow -> local_faldoi -> global_faldoi`` through
   their ``main(argv)`` on files written to a temporary directory.

The last line of standard output is one JSON object naming the device.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

CROP_D = (150, 300, 160, 160)     # phase d window (y0, x0, h, w)
BSZ_D = 512                       # phase d batch: keeps the CPU run short
SEED = 0
B = 8192                          # patches per kernel check (sweep bsz)
WARP_TOL = 1e-5                   # gather warp, frames normalised to [0, 1]
PARITY_GATE = 0.05                # px, the repo's parity gate
EPE_SHARE = 0.25                  # final EPE <= 25% of the zero-flow EPE


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


class Report:
    """Prints one line per phase result, each with the card and the wall
    time, and remembers failures."""

    def __init__(self, card_line: str):
        self.card = card_line
        self.failed = []

    def line(self, phase: str, msg: str, secs: float):
        print(f"[{phase}] {msg} | card: {self.card} | {secs:.3f} s",
              flush=True)

    def check(self, phase: str, ok: bool, msg: str, secs: float):
        self.line(phase, ("PASS " if ok else "FAIL ") + msg, secs)
        if not ok:
            self.failed.append(f"{phase}: {msg}")


# ---------------------------------------------------------------------------
# Phase b: kernels at real widths (also run by tests/test_gpu.py)
# ---------------------------------------------------------------------------


def check_crop(b=B, h=436, w=1024, p=11, nch=5, seed=SEED):
    """The sweep's patch crop: ``b`` (p, p, nch) windows of the edge-padded
    channels-last state stack, against NumPy indexing.  A crop copies
    values, so the result must be bit-identical, NaNs included.  Returns
    (number of differing bits patterns, elements compared)."""
    import jax
    import jax.numpy as jnp

    from faldoi_tpu.core.patch_solver import crop_padded

    rng = np.random.RandomState(seed)
    planes = rng.randn(h, w, nch).astype(np.float32)
    planes[rng.rand(h, w) < 0.3, :2] = np.nan     # unfixed out_u/out_v
    stack = np.pad(planes, ((0, p), (0, p), (0, 0)), mode="edge")
    oy = rng.randint(0, h, b).astype(np.int32)
    ox = rng.randint(0, w, b).astype(np.int32)
    crop = jax.jit(jax.vmap(crop_padded, in_axes=(None, 0, 0, None)),
                   static_argnums=3)
    got = np.asarray(crop(jnp.asarray(stack), jnp.asarray(oy),
                          jnp.asarray(ox), p))
    ar = np.arange(p)
    ref = stack[oy[:, None, None] + ar[None, :, None],
                ox[:, None, None] + ar[None, None, :]]
    diff = int((got.view(np.uint32) != ref.view(np.uint32)).sum())
    return diff, got.size


def _warp_planes(seed=SEED):
    """Normalised, smoothed I1 of the seeded pair with its centred
    gradients (the planes every warp of the pipeline samples) and the known
    flow."""
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu.synthetic import make_pair

    pair = make_pair(seed)
    a, b = prepare_pair(pair.i0, pair.i1)
    bx, by = centered_gradient(b)
    return a, b, bx, by, pair.flow


def check_patch_warp(b=B, p=11, seed=SEED):
    """The patch solvers' warp (functionals._warp3: one 4x4x3 gather per
    cell) on ``b`` patches under the seeded flow, against a float64 NumPy
    evaluation of the reference stencil.  Returns the max abs error."""
    import jax
    import jax.numpy as jnp

    from faldoi_tpu.core.functionals import _warp3, make_solver_consts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu import params as P
    from tests.ref_numpy import bicubic_at_vec

    a, i1, i1x, i1y, flow = _warp_planes(seed)
    h, w = a.shape
    sc = make_solver_consts(P.M_TVL1, pad_for_crops(a, p), i1, i1x, i1y,
                            40.0, 0.3, 0.125, 0.01, p=p)
    rng = np.random.RandomState(seed + 1)
    oy = rng.randint(0, h - p + 1, b)
    ox = rng.randint(0, w - p + 1, b)
    ar = np.arange(p)
    rows = oy[:, None, None] + ar[None, :, None]
    cols = ox[:, None, None] + ar[None, None, :]
    u = flow[rows, cols, 0]
    v = flow[rows, cols, 1]
    inbox = jnp.ones((p, p), bool)

    def one(oy_k, ox_k, u_k, v_k):
        gx = (ox_k + jnp.arange(p)[None, :]).astype(jnp.float32)
        gy = (oy_k + jnp.arange(p)[:, None]).astype(jnp.float32)
        return jnp.stack(_warp3(sc, gx, gy, u_k, v_k, inbox))

    got = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(oy), jnp.asarray(ox), jnp.asarray(u), jnp.asarray(v)))
    # sample where the kernel is asked to: float32 positions
    xs = (cols.astype(np.float32) + u).astype(np.float64)
    ys = (rows.astype(np.float32) + v).astype(np.float64)
    err = 0.0
    for c, plane in enumerate((i1, i1x, i1y)):
        ref = bicubic_at_vec(np.asarray(plane), xs, ys, False)
        err = max(err, float(np.abs(got[:, c] - ref).max()))
    return err


def check_image_warp(seed=SEED):
    """The global step's whole-image warp of 3 planes at 436x1024
    (ops.bicubic.bicubic_warp_stack, border_out as the global step uses it)
    against float64 NumPy.  Returns the max abs error."""
    import jax
    import jax.numpy as jnp

    from faldoi_tpu.ops.bicubic import bicubic_warp_stack
    from tests.ref_numpy import bicubic_at_vec

    _, i1, i1x, i1y, flow = _warp_planes(seed)
    planes = jnp.stack([i1, i1x, i1y])
    got = np.asarray(jax.jit(bicubic_warp_stack, static_argnums=3)(
        planes, jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]), True))
    h, w = i1.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    xs = (xx + flow[..., 0]).astype(np.float64)
    ys = (yy + flow[..., 1]).astype(np.float64)
    err = 0.0
    for c in range(3):
        ref = bicubic_at_vec(np.asarray(planes[c]), xs, ys, True)
        err = max(err, float(np.abs(got[c] - ref).max()))
    return err


def check_topk(k=B, n=436 * 1024, seed=SEED):
    """The sweep's candidate selection over an ``n``-pixel field with
    ``k`` slots against a NumPy argsort.  Returns the number of selected
    indices outside the reference set, ties at the k-th energy aside."""
    import jax
    import jax.numpy as jnp

    from faldoi_tpu.core.local_step import select_candidates

    rng = np.random.RandomState(seed + 2)
    e = rng.rand(n).astype(np.float32)
    e[rng.rand(n) < 0.4] = np.inf      # fixed / never-queued pixels
    e_pop, idx = jax.jit(select_candidates, static_argnums=1)(
        jnp.asarray(e), k)
    idx = np.asarray(idx)
    ref = np.argsort(e, kind="stable")[:k]
    kth = e[ref[-1]]
    extra = set(idx.tolist()) ^ set(ref.tolist())
    bad = [i for i in extra if e[i] != kth]
    sorted_ok = bool(np.all(np.diff(np.asarray(e_pop)) >= 0))
    return len(bad) + (0 if sorted_ok else 1)


# ---------------------------------------------------------------------------
# Phases c-e: the main path
# ---------------------------------------------------------------------------


def _params():
    from faldoi_tpu import params as P

    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    return prm


def run_pipeline(pair, stats=None, **kw):
    """prepare_pair -> match_growing -> tvl2_global with default arguments
    (``kw`` goes to match_growing).  Returns (local flow, final flow,
    local s, global s)."""
    import jax.numpy as jnp

    from faldoi_tpu.core.global_step import tvl2_global
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair

    t0 = time.time()
    a, b = prepare_pair(pair.i0, pair.i1)
    rg, _, _ = match_growing(pair.seeds_fwd, pair.seeds_bwd, a, b,
                             _params(), stats=stats, **kw)
    t1 = time.time()
    u1, u2 = tvl2_global(a, b, jnp.asarray(rg[..., 0]),
                         jnp.asarray(rg[..., 1]))
    var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
    return rg, var, t1 - t0, time.time() - t1


def phase_c(rep, pair, counter):
    from faldoi_tpu.synthetic import epe

    zero = epe(np.zeros_like(pair.flow), pair.flow)
    outs = []
    for label in ("cold", "warm 1", "warm 2"):
        n0 = counter.programs
        stats = {}
        t = time.time()
        rg, var, t_loc, t_glob = run_pipeline(pair, stats)
        secs = time.time() - t
        finite = float(np.isfinite(rg).all(axis=-1).mean())
        e = epe(var, pair.flow)
        rep.line("c", f"{label}: local {t_loc:.3f} s, global {t_glob:.3f} s, "
                 f"sweeps {stats.get('sweeps')}, finite after local "
                 f"{100 * finite:.3f}%, EPE {e:.4f} (zero-flow {zero:.4f}), "
                 f"programs compiled or loaded {counter.programs - n0} "
                 f"(persistent-cache hits so far {counter.cache_hits}, "
                 f"compile {counter.compile_s:.1f} s)", secs)
        rep.check("c", finite == 1.0, f"{label}: every pixel finite after "
                  "the local step", 0.0)
        rep.check("c", e <= EPE_SHARE * zero,
                  f"{label}: EPE {e:.4f} <= {EPE_SHARE} x zero-flow EPE "
                  f"{zero:.4f}", 0.0)
        outs.append(var)
    d = np.abs(outs[1] - outs[2])
    run_epe = float(np.hypot(d[..., 0], d[..., 1]).mean())
    rep.check("c", run_epe <= PARITY_GATE,
              f"warm run-to-run: max |flow diff| {float(d.max()):.3e} px, "
              f"mean endpoint diff {run_epe:.3e} px (gate {PARITY_GATE})",
              0.0)
    return outs[-1], EPE_SHARE * zero


def phase_d(rep):
    import jax

    from faldoi_tpu.synthetic import make_pair

    pair = make_pair(SEED, CROP_D)
    t = time.time()
    _, var_gpu, _, _ = run_pipeline(pair, bsz=BSZ_D)
    t_gpu = time.time() - t
    t = time.time()
    with jax.default_device(jax.devices("cpu")[0]):
        _, var_cpu, _, _ = run_pipeline(pair, bsz=BSZ_D)
    t_cpu = time.time() - t
    d = var_gpu - var_cpu
    mean = float(np.hypot(d[..., 0], d[..., 1]).mean())
    rep.check("d", mean <= PARITY_GATE,
              f"{CROP_D[2]}x{CROP_D[3]} crop, bsz {BSZ_D}, GPU vs CPU: mean "
              "endpoint diff "
              f"{mean:.3e} px (gate {PARITY_GATE}); GPU {t_gpu:.3f} s, CPU "
              f"{t_cpu:.3f} s incl. compile", t_gpu + t_cpu)


def phase_e(rep, pair, var_c, bound):
    from faldoi_tpu.cli import global_faldoi, local_faldoi, sparse_flow
    from faldoi_tpu.io import read_flo
    from faldoi_tpu.io.image import write_netpbm
    from faldoi_tpu.synthetic import epe, write_matches

    h, w = pair.flow.shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)  # noqa: E731
        write_netpbm(f("i0.ppm"), pair.i0.transpose(1, 2, 0))
        write_netpbm(f("i1.ppm"), pair.i1.transpose(1, 2, 0))
        with open(f("ims.txt"), "w") as fh:
            fh.write(f("i0.ppm") + "\n" + f("i1.ppm") + "\n")
        write_matches(f("m1.txt"), pair.matches_fwd)
        write_matches(f("m2.txt"), pair.matches_bwd)
        t = time.time()
        rcs = [
            sparse_flow.main([f("m1.txt"), str(w), str(h), f("s1.flo")]),
            sparse_flow.main([f("m2.txt"), str(w), str(h), f("s2.flo")]),
            local_faldoi.main([f("ims.txt"), f("s1.flo"), f("s2.flo"),
                               f("rg.flo"), f("sim.pfm")]),
            global_faldoi.main([f("ims.txt"), f("rg.flo"), f("var.flo")]),
        ]
        secs = time.time() - t
        ok = rcs == [0, 0, 0, 0]
        var = read_flo(f("var.flo")) if ok else None
    if not ok:
        rep.check("e", False, f"CLI exit codes {rcs}", secs)
        return
    d_c = epe(var, var_c)
    e = epe(var, pair.flow)
    rep.check("e", d_c <= bound and e <= bound,
              f"CLI final flow vs phase c: mean endpoint diff {d_c:.4f} px; "
              f"EPE {e:.4f}; both <= phase-c bound {bound:.4f}", secs)


def smoke() -> int:
    import jax

    from faldoi_tpu.profiling import CompileCounter, enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    counter = CompileCounter()
    card_line = card()
    print(card_line, flush=True)
    rep = Report(card_line)
    t = time.time()
    rep.line("a", f"platform {devs[0].platform}, kind {devs[0].device_kind}, "
             f"count {len(devs)}, jax {jax.__version__}, XLA_FLAGS="
             f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache}",
             time.time() - t)

    def run(phase, fn, *args):
        t0 = time.time()
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            rep.check(phase, False, f"{fn.__name__} raised", time.time() - t0)
            return None

    def kernels():
        t0 = time.time()
        diff, n = check_crop()
        rep.check("b", diff == 0, f"crop {B}x11x11x5 of the 447x1035 state "
                  f"stack: {diff} of {n} values differ (tolerance 0: exact "
                  "copy, dynamic_slice gather)", time.time() - t0)
        t0 = time.time()
        err = check_patch_warp()
        rep.check("b", err <= WARP_TOL, f"patch warp {B}x11x11x3 under the "
                  f"seeded flow: max abs err {err:.3e} (tolerance {WARP_TOL}; "
                  "float32 4x4 gather + multiply-add, no matmul) vs NumPy "
                  "float64", time.time() - t0)
        t0 = time.time()
        err = check_image_warp()
        rep.check("b", err <= WARP_TOL, f"image warp 3x436x1024: max abs "
                  f"err {err:.3e} (tolerance {WARP_TOL}; float32 4x4x3 "
                  "gather, no matmul) vs NumPy float64", time.time() - t0)
        t0 = time.time()
        bad = check_topk()
        rep.check("b", bad == 0, f"top-k k={B} over {436 * 1024} pixels: "
                  f"{bad} indices outside the argsort set, ties aside "
                  "(exact lax.top_k)", time.time() - t0)

    from faldoi_tpu.synthetic import make_pair

    run("b", kernels)
    pair = make_pair(SEED)
    res = run("c", phase_c, rep, pair, counter)
    run("d", phase_d, rep)
    if res is not None:
        run("e", phase_e, rep, pair, *res)
    else:
        rep.check("e", False, "skipped: phase c produced no flow", 0.0)
    if rep.failed:
        print("FAILED: " + "; ".join(rep.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


# ---------------------------------------------------------------------------
# --ab: timed A/B of the settled decisions (builder's tool, one GPU)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="PARENT",
                    help="run the timed A/B against a checkout of the "
                         "parent commit instead of the smoke phases")
    args = ap.parse_args(argv)
    if args.ab:
        from scripts.ab_h100 import ab_runs

        return ab_runs(args.ab)
    return smoke()


if __name__ == "__main__":
    sys.exit(main())

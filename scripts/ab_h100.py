"""Timed A/B runs behind ``python chip_smoke.py --ab PARENT`` (one GPU).

Each hand-shaped mechanism this repository once carried — block-gather
crops, windowed one-hot warps, approximate top-k, the rung prewarm thread,
chunked against fused execution — is timed against the plain version that
XLA compiles, on the same card in one call.  The old mechanisms are run
from ``PARENT``, a checkout of the commit that still has them.

The parent process stays off the GPU and runs every variant in a child
process of its own, one after the other (one JAX process per card).  Each
child gets an empty compile cache, times one cold run of the library path
``prepare_pair -> match_growing -> tvl2_global`` on the seeded 436x1024
pair, then three warm runs, and reports their median.  A kernel child
times each kernel pair at production width (median of 20 calls after 3
warm-up calls) and its error against float64 NumPy.

Results go to ``chiprun_out/ab/results.jsonl`` and one line per variant on
standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "chiprun_out", "ab")

FUSED = {"FALDOI_GROW_MODE": "fused"}
E2E = [
    # (label, tree, environment[, patch applied in the child]); job k is
    # E2E[k - 1], job 0 the kernels
    ("parent defaults: chunked, block-gather crops, windowed warps "
     "(HIGH), approx top-k, prewarm", "parent", {}),
    ("parent, FALDOI_BLOCKGATHER=0 (slice crops, windowed warps)", "parent",
     {"FALDOI_BLOCKGATHER": "0"}),
    ("parent, FALDOI_TOPK=exact", "parent", {"FALDOI_TOPK": "exact"}),
    ("parent, prewarm off", "parent", {"FALDOI_GROW_PREWARM": "0"}),
    ("this tree: plain crops, gather warps, top_k; chunked, prewarm",
     "self", {"FALDOI_GROW_MODE": "chunked"}),
    ("this tree, chunked, prewarm off", "self",
     {"FALDOI_GROW_MODE": "chunked", "FALDOI_GROW_PREWARM": "0"}),
    ("this tree, fused", "self", FUSED),
    ("this tree, fused, sort-based exact selection", "self", FUSED,
     "sort_select"),
    ("parent, fused: block-gather crops, windowed warps (HIGH), approx "
     "top-k", "parent", FUSED),
    ("parent, fused, FALDOI_BLOCKGATHER=0", "parent",
     dict(FUSED, FALDOI_BLOCKGATHER="0")),
    ("parent, fused, FALDOI_TOPK=exact", "parent",
     dict(FUSED, FALDOI_TOPK="exact")),
    ("parent, fused, FALDOI_WARP_PREC=highest", "parent",
     dict(FUSED, FALDOI_WARP_PREC="highest")),
]


def sort_select(eligible, bsz):
    """Exact selection by one stable key-value sort and a slice, for the
    selection A/B."""
    import jax.numpy as jnp
    from jax import lax

    e, idx = lax.sort((eligible, jnp.arange(eligible.shape[0],
                                            dtype=jnp.int32)),
                      num_keys=1, is_stable=True)
    return e[:bsz], idx[:bsz]


def _card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    return r.stdout.strip()


def ab_runs(parent: str, only=None) -> int:
    """Run every job (or the jobs listed in ``only``, in that order,
    repeats allowed) in a child process of its own; returns 0 when all
    children succeed."""
    from faldoi_tpu.synthetic import make_pair

    parent = os.path.abspath(parent)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = _card()
    print(f"card: {card}", flush=True)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        pair = make_pair(0)
        npz = os.path.join(tmp, "pair.npz")
        np.savez(npz, **pair._asdict())
        jobs = [("kernels", "parent", {}, "kernels", "")]
        jobs += [(e[0], e[1], e[2], "e2e", e[3] if len(e) > 3 else "")
                 for e in E2E]
        for run, k in enumerate(range(len(jobs)) if only is None else only):
            label, tree, env, kind, patch = jobs[k]
            out = os.path.join(tmp, f"r{run}.json")
            cenv = dict(os.environ, **env)
            cenv["JAX_COMPILATION_CACHE_DIR"] = os.path.join(tmp, f"c{run}")
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   kind, "--tree", parent if tree == "parent" else HERE,
                   "--self", HERE, "--pair", npz, "--out", out,
                   "--patch", patch]
            t = time.time()
            p = subprocess.run(cmd, env=cenv, capture_output=True, text=True)
            wall = time.time() - t
            if p.returncode != 0 or not os.path.exists(out):
                rc = 1
                print(f"[ab] {label}: FAILED rc={p.returncode}\n"
                      f"{p.stderr[-3000:]}", flush=True)
                continue
            with open(out) as fh:
                res = json.load(fh)
            res.update(label=label, env=env, card=card, process_s=wall)
            with open(os.path.join(OUT_DIR, "results.jsonl"), "a") as fh:
                fh.write(json.dumps(res) + "\n")
            print(f"[ab] {label}: {json.dumps(res)}", flush=True)
    return rc


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------


def _median_time(fn, *args, n=20, warm=3):
    import jax

    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def _load_module(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child_kernels(pair, self_dir):
    """Old kernels (from the parent tree on sys.path) against the plain
    ones, at production width."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.ops import blockgather as bg
    from faldoi_tpu.ops import bicubic as old
    from faldoi_tpu.core.functionals import make_warp_blocks, WARP_BSTRIDE
    from faldoi_tpu.ops.stencils import centered_gradient

    new = _load_module("bicubic_new",
                       os.path.join(self_dir, "faldoi_tpu/ops/bicubic.py"))
    ref = _load_module("ref_numpy", os.path.join(self_dir,
                                                 "tests/ref_numpy.py"))
    res = {}
    rng = np.random.RandomState(0)
    B, p, h, w = 8192, 11, 436, 1024

    # --- patch crop of the sweep's 5-channel state stack
    planes = rng.randn(h, w, 5).astype(np.float32)
    planes[rng.rand(h, w) < 0.3, :2] = np.nan
    stack = jnp.asarray(np.pad(planes, ((0, p), (0, p), (0, 0)), "edge"))
    stack_blk = jnp.moveaxis(bg.make_crop_blocks(jnp.moveaxis(
        jnp.nan_to_num(stack, nan=bg.SENTINEL), -1, 0)), 0, -1)
    oy = jnp.asarray(rng.randint(0, h, B))
    ox = jnp.asarray(rng.randint(0, w, B))

    def crop_blk(sb, oy, ox):
        out = jax.vmap(lambda a, b: bg.crop_stack_blocks_fast(sb, a, b, p))(
            oy, ox)
        return jnp.where(out > bg.SENTINEL / 2, jnp.nan, out)

    def crop_slice(st, oy, ox):
        return jax.vmap(lambda a, b: lax.dynamic_slice(
            st, (a, b, 0), (p, p, 5)))(oy, ox)

    f_blk, f_sl = jax.jit(crop_blk), jax.jit(crop_slice)
    same = np.array_equal(np.asarray(f_blk(stack_blk, oy, ox)),
                          np.asarray(f_sl(stack, oy, ox)), equal_nan=True)
    res["crop_blockgather_s"] = _median_time(f_blk, stack_blk, oy, ox)
    res["crop_dynamic_slice_s"] = _median_time(f_sl, stack, oy, ox)
    res["crop_equal"] = bool(same)

    # --- patch warp of (i1, i1x, i1y) under the known flow
    a, b = prepare_pair(pair["i0"], pair["i1"])
    bx, by = centered_gradient(b)
    flow = pair["flow"]
    st3 = jnp.stack([b, bx, by])
    blocks = make_warp_blocks(st3)
    hwc = jnp.stack([b, bx, by], axis=-1)
    py = rng.randint(0, h - p + 1, B)
    px = rng.randint(0, w - p + 1, B)
    ar = np.arange(p)
    rows = py[:, None, None] + ar[None, :, None]
    cols = px[:, None, None] + ar[None, None, :]
    uu = jnp.asarray((cols + flow[rows, cols, 0]).astype(np.float32))
    vv = jnp.asarray((rows + flow[rows, cols, 1]).astype(np.float32))
    exact = np.stack([ref.bicubic_at_vec(np.asarray(pl), np.asarray(uu),
                                         np.asarray(vv), False)
                      for pl in (b, bx, by)], axis=1)

    for prec in ("high", "highest"):
        os.environ["FALDOI_WARP_PREC"] = prec
        f = jax.jit(jax.vmap(lambda x, y: old.bicubic_window_sample_blocks(
            blocks, h, w, x, y, False, WARP_BSTRIDE, nrows=24)))
        got = np.asarray(f(uu, vv))
        res[f"patch_warp_window_{prec}_s"] = _median_time(f, uu, vv)
        res[f"patch_warp_window_{prec}_err"] = float(
            np.abs(got - exact).max())
    f = jax.jit(jax.vmap(lambda x, y: new.bicubic_interp_at(hwc, x, y,
                                                            False)))
    got = np.moveaxis(np.asarray(f(uu, vv)), -1, 1)
    res["patch_warp_gather_s"] = _median_time(f, uu, vv)
    res["patch_warp_gather_err"] = float(np.abs(got - exact).max())

    # --- whole-image warp of the same 3 planes (global step, FB prune)
    u = jnp.asarray(flow[..., 0])
    v = jnp.asarray(flow[..., 1])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    exact = np.stack([ref.bicubic_at_vec(np.asarray(pl), xx + flow[..., 0],
                                         yy + flow[..., 1], True)
                      for pl in (b, bx, by)])
    for prec in ("high", "highest"):
        os.environ["FALDOI_WARP_PREC"] = prec
        f = jax.jit(lambda s, u, v: old.bicubic_warp_stack(s, u, v, True))
        got = np.asarray(f(st3, u, v))
        res[f"image_warp_tiled_{prec}_s"] = _median_time(f, st3, u, v)
        res[f"image_warp_tiled_{prec}_err"] = float(np.abs(got - exact).max())
    f = jax.jit(lambda s, u, v: new.bicubic_warp_stack(s, u, v, True))
    got = np.asarray(f(st3, u, v))
    res["image_warp_gather_s"] = _median_time(f, st3, u, v)
    res["image_warp_gather_err"] = float(np.abs(got - exact).max())

    # --- candidate selection over the full field
    e = rng.rand(h * w).astype(np.float32)
    e[rng.rand(h * w) < 0.4] = np.inf
    ej = jnp.asarray(e)
    f_ap = jax.jit(lambda x: lax.approx_max_k(-x, B, recall_target=0.95))
    f_tk = jax.jit(lambda x: lax.top_k(-x, B))
    res["topk_approx_s"] = _median_time(f_ap, ej)
    res["topk_exact_s"] = _median_time(f_tk, ej)
    ref_set = set(np.argsort(e, kind="stable")[:B].tolist())
    res["topk_approx_recall"] = len(
        ref_set & set(np.asarray(f_ap(ej)[1]).tolist())) / B
    f_so = jax.jit(lambda x: sort_select(x, B))
    res["topk_sort_s"] = _median_time(f_so, ej)
    res["topk_sort_equal"] = set(np.asarray(f_so(ej)[1]).tolist()) == ref_set
    for k in (512, 4096):
        res[f"topk_exact_k{k}_s"] = _median_time(
            jax.jit(lambda x, k=k: lax.top_k(-x, k)), ej)
        res[f"topk_sort_k{k}_s"] = _median_time(
            jax.jit(lambda x, k=k: sort_select(x, k)), ej)
    return res


def child_e2e(pair):
    """Cold run then three warm runs of the library path."""
    import jax.numpy as jnp

    from faldoi_tpu import params as P
    from faldoi_tpu.core.global_step import tvl2_global
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair

    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = P.LOCAL_ITER
    prm.epsilon = P.FB_TOL
    flow = pair["flow"]

    def once():
        t0 = time.perf_counter()
        a, b = prepare_pair(pair["i0"], pair["i1"])
        rg, _, _ = match_growing(pair["seeds_fwd"], pair["seeds_bwd"], a, b,
                                 prm)
        t1 = time.perf_counter()
        u1, u2 = tvl2_global(a, b, jnp.asarray(rg[..., 0]),
                             jnp.asarray(rg[..., 1]))
        var = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
        t2 = time.perf_counter()
        epe = float(np.hypot(var[..., 0] - flow[..., 0],
                             var[..., 1] - flow[..., 1]).mean())
        return t2 - t0, t1 - t0, t2 - t1, epe, float(
            np.isfinite(rg).all(axis=-1).mean())

    cold = once()
    warm = [once() for _ in range(3)]
    tot = [r[0] for r in warm]
    return {"cold_s": cold[0], "warm_s": tot,
            "warm_median_s": float(np.median(tot)),
            "local_median_s": float(np.median([r[1] for r in warm])),
            "global_median_s": float(np.median([r[2] for r in warm])),
            "epe": warm[-1][3], "finite": warm[-1][4]}


def _child(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=("kernels", "e2e"))
    ap.add_argument("--tree")
    ap.add_argument("--self")
    ap.add_argument("--pair")
    ap.add_argument("--out")
    ap.add_argument("--patch", default="")
    args = ap.parse_args(argv)
    sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, args.tree)
    try:  # the parent tree imports PIL at module level; frames need none
        import PIL  # noqa: F401
    except ImportError:
        import types

        stub = types.ModuleType("PIL")
        stub.Image = None
        sys.modules["PIL"] = stub
    import jax

    assert jax.devices()[0].platform == "gpu", "A/B runs need the GPU"
    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    pair = dict(np.load(args.pair))
    if args.patch == "sort_select":
        from faldoi_tpu.core import local_step

        local_step.select_candidates = sort_select
    res = (child_kernels(pair, args.self) if args.child == "kernels"
           else child_e2e(pair))
    with open(args.out, "w") as fh:
        json.dump(res, fh)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.exit(_child(sys.argv[1:]))
    ap = argparse.ArgumentParser(description="timed A/B runs on one GPU")
    ap.add_argument("parent")
    ap.add_argument("--only", type=lambda s: [int(x) for x in s.split(",")])
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.exit(ab_runs(a.parent, a.only))

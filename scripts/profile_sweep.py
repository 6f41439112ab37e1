#!/usr/bin/env python
"""Per-component timing of the growing sweep on the real device.

Times the pieces of ``local_step._sweep_body`` as standalone jitted programs
at realistic shapes (436x1024 Sintel, bsz in {512, 2048, 8192}) so we know
where the per-sweep milliseconds go before optimizing anything:

  topk      lax.top_k over the (n,) candidate field
  stack     plane stack + edge pad (6 channels)
  crop      vmapped (p,p,C) dynamic_slice crops
  fill_rb   vmapped red-black poisson fill (2 channels)
  fill_gs   vmapped exact raster-GS poisson fill (2 channels)
  solve     vmapped TVL1 patch solve (4 PD iters, 1 warp)
  scatter   the 3 scatter-payload groups at sweep shapes
  sweep     one full _sweep_body via grow_chunk(chunk=1)
  sweep8    grow_chunk(chunk=8), reported per sweep

Usage: python scripts/profile_sweep.py [bsz ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from faldoi_tpu.core import local_step as ls
from faldoi_tpu.core.functionals import solve_tvl1, make_solver_consts
from faldoi_tpu.ops.poisson import poisson_fill_canvas
from faldoi_tpu.core.patch_solver import pad_for_crops

H, W, WR = 436, 1024, 5
P = 2 * WR + 1
N = H * W


def bench(fn, *args, reps=10, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3  # ms


def main():
    bszs = [int(a) for a in sys.argv[1:]] or [512, 2048, 8192]
    from faldoi_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"# device: {dev}")
    rng = np.random.default_rng(0)

    # realistic-ish planes
    i0 = jnp.asarray(rng.random((H, W), np.float32))
    i1 = jnp.asarray(rng.random((H, W), np.float32))
    sc = make_solver_consts(0, jnp.pad(i0, ((0, P), (0, P)), mode="edge"),
                            i1, i1, i1, 40.0, 0.3, 0.125, 0.01)

    cand_e = jnp.asarray(
        np.where(rng.random(N + 1) < 0.05, rng.random(N + 1), np.inf)
        .astype(np.float32))
    fixed = jnp.asarray(rng.random(N + 1) < 0.3)
    plane = jnp.asarray(rng.random((N + 1,), np.float32))

    # --- topk
    f_topk = jax.jit(lambda e: jax.lax.top_k(-e[:N], 8192))
    print(f"topk(8192)              {bench(f_topk, cand_e):8.2f} ms")
    f_topk1 = jax.jit(lambda e: jax.lax.top_k(-e[:N], 512))
    print(f"topk(512)               {bench(f_topk1, cand_e):8.2f} ms")

    # --- stack+pad (6 planes)
    def stack6(a, b):
        planes = [a[:N].reshape(H, W)] * 4 + [b[:N].reshape(H, W)] * 2
        return jnp.pad(jnp.stack(planes, axis=-1), ((0, P), (0, P), (0, 0)),
                       mode="edge")
    f_stack = jax.jit(stack6)
    print(f"stack+pad 6ch           {bench(f_stack, plane, plane):8.2f} ms")
    stk = f_stack(plane, plane)

    for bsz in bszs:
        print(f"--- bsz={bsz}")
        idx = jnp.asarray(rng.integers(0, N, bsz))
        i, j, oy, ox, ph, pw = ls._patch_geometry(idx, H, W, WR)

        # --- crop
        def crop(oyv, oxv):
            return jax.vmap(
                lambda oy_k, ox_k: jax.lax.dynamic_slice(
                    stk, (oy_k, ox_k, 0), (P, P, 6)),
                out_axes=-1)(oyv, oxv)
        f_crop = jax.jit(crop)
        print(f"  crop {bsz}x(11,11,6)   {bench(f_crop, oy, ox):8.2f} ms")

        # --- fills
        canv = jnp.where(
            jnp.asarray(rng.random((P, P, bsz)) < 0.4),
            jnp.asarray(rng.random((P, P, bsz), np.float32)), jnp.nan)

        def fill(exact):
            def go(c, phv, pwv):
                return jax.vmap(
                    lambda ck, phk, pwk: poisson_fill_canvas(
                        ck, phk, pwk, exact=exact),
                    in_axes=(-1, 0, 0), out_axes=-1)(c, phv, pwv)
            return jax.jit(go)
        print(f"  fill_rb x2            "
              f"{2 * bench(fill(False), canv, ph, pw):8.2f} ms")
        print(f"  fill_gs x2            "
              f"{2 * bench(fill(True), canv, ph, pw):8.2f} ms")

        # --- solve
        u0 = jnp.asarray(rng.random((P, P, bsz), np.float32))
        v0 = jnp.asarray(rng.random((P, P, bsz), np.float32))
        c0 = jnp.zeros_like(u0)

        def solve(iv, jv, oyv, oxv, phv, pwv, u, v, c):
            return jax.vmap(
                lambda i_k, j_k, oy_k, ox_k, ph_k, pw_k, uk, vk, ck:
                solve_tvl1(sc, i_k, j_k, oy_k, ox_k, ph_k, pw_k,
                           uk, vk, ck, P, 1, 4, WR),
                in_axes=(0, 0, 0, 0, 0, 0, -1, -1, -1),
                out_axes=(-1, -1, -1, 0),
            )(iv, jv, oyv, oxv, phv, pwv, u, v, c)
        f_solve = jax.jit(solve)
        print(f"  solve tvl1 4it        "
              f"{bench(f_solve, i, j, oy, ox, ph, pw, u0, v0, c0):8.2f} ms")

        # --- scatters (3 payload groups as in _sweep_body)
        q4 = jnp.asarray(rng.integers(0, N, 4 * bsz))
        e4 = jnp.asarray(rng.random(4 * bsz, np.float32))
        ok4 = jnp.asarray(rng.random(4 * bsz) < 0.5)
        flat_q = jnp.asarray(rng.integers(0, N, P * P * bsz))
        keyv = jnp.asarray(rng.random(P * P * bsz, np.float32))
        okf = jnp.asarray(rng.random(P * P * bsz) < 0.9)

        def scat(ce, cu, cv, en, ou, ov, wu, wv):
            ce, cu, cv, _ = ls._scatter_min_payload(
                ce, cu, cv, None, q4, e4, e4, e4, None, ok4, N)
            en, ou, ov, _ = ls._scatter_min_payload(
                en, ou, ov, None, q4, e4, e4, e4, None, ok4, N)
            kb = jnp.full((N + 1,), -jnp.inf, jnp.float32)
            _, wu, wv, _ = ls._scatter_max_payload(
                kb, wu, wv, None, flat_q, keyv, keyv, keyv, None, okf, N)
            return ce, cu, cv, en, ou, ov, wu, wv
        f_scat = jax.jit(scat)
        args = (cand_e, plane, plane, cand_e, plane, plane, plane, plane)
        print(f"  scatters (3 groups)   {bench(f_scat, *args):8.2f} ms")

        # --- full sweep via grow_chunk
        st = ls.init_state(H, W)
        st = st._replace(
            cand_e=cand_e, cand_u=plane, cand_v=plane, fixed=fixed,
            out_u=jnp.where(fixed, plane, jnp.nan),
            out_v=jnp.where(fixed, plane, jnp.nan),
            wu=plane, wv=plane)
        trust = jnp.ones((N + 1,), jnp.float32)
        sal = jnp.ones((N + 1,), jnp.float32)

        def run_chunk(chunk):
            def go(s):
                s2, acc = ls.grow_chunk(
                    s, solve_tvl1, sc, trust, sal, jnp.asarray(0, jnp.int32),
                    H, W, WR, bsz, 1, 4, delta=0.01, chunk=chunk,
                    fill="patch_rb", floor=bsz // 16, relax=False,
                    delta_rel=0.5, floor_scale=64, with_chi=False)
                return s2.cand_e, acc
            return jax.jit(go)
        t1 = bench(run_chunk(1), st, reps=5)
        t8 = bench(run_chunk(8), st, reps=3)
        print(f"  sweep (chunk=1)       {t1:8.2f} ms")
        print(f"  sweep (chunk=8)/8     {t8 / 8:8.2f} ms")


if __name__ == "__main__":
    main()

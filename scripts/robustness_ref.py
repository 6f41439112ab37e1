#!/usr/bin/env python
"""Self-contained ROBUSTNESS grid: ours AND the reference binaries on the
SAME committed seeds (the earlier grid carried only our
EPE numbers; the reference's numbers lived in prose).

For every (dataset, matcher, epsilon) row of the r4 grid, this script:

1. materialises the seed pair (fwd/bwd sparse .flo) from the COMMITTED
   match files — ``tests/golden/deep_mt_{1,2}.flo`` for clean/easy deep,
   ``tests/golden/pairs/<pass>_<level>_mt_{1,2}.txt`` for the other deep
   rows, and the built-in SIFT matcher's cut lists (generated once and
   saved to ``tests/golden/pairs/sift_*``) for the sift rows (the vendored
   ``sift_cli`` needs libpng12 and cannot run on this host — the built-in
   matcher IS the de-facto L4 here, PARITY.md L6 row);
2. runs the REBUILT REFERENCE BINARIES (local_faldoi + global_faldoi,
   ``-m 0 -fb_thresh <eps>``) on those seeds (~5 min/row on this 1-core
   host) and scores vs GT with the MPI-Sintel occ/invalid masks;
3. runs OUR pipeline (cli.local_faldoi + cli.global_faldoi, same seeds,
   same flags) and scores identically.

Each row gets ours (epe_all/mat/umat) and reference (ref_epe_*) columns
from identical inputs, making ROBUSTNESS.jsonl self-contained parity
evidence.  Results append to ROBUSTNESS_r05.jsonl; pass --replace to
rewrite ROBUSTNESS.jsonl from the completed grid at the end.

Reference counterpart: scripts_python/tests_robustness_epsilon.sh:1-53
(which swept epsilon and evaluated externally in MATLAB).
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF = "/root/reference/example_data"
# The prebuilt /root/reference/build binaries were compiled WITHOUT OpenMP
# and their growing loops are #ifdef _OPENMP'd out (SURVEY "OpenMP-required
# quirk") — they exit in ~1 s with empty output.  Use the rebuilt ones
# (scripts/run_parity.py docstring has the recipe).
REFBUILD = os.environ.get("FALDOI_REFBUILD", "/tmp/refbuild")
GOLD = os.path.join(ROOT, "tests/golden")

GRID = (
    [(ds, "deep", eps) for ds in ("clean/easy", "final/easy", "clean/medium",
                                  "final/medium", "clean/hard", "final/hard")
     for eps in (2.0, 13.0)]
    + [(ds, "sift", eps) for ds in ("clean/easy", "clean/medium",
                                    "clean/hard")
       for eps in (0.45, 2.0)]
)


def epe_stats(est, gt, occ, invalid, prefix=""):
    import numpy as np

    valid = ~invalid & np.isfinite(gt[..., 0]) & np.isfinite(est[..., 0])
    err = np.hypot(est[..., 0] - gt[..., 0], est[..., 1] - gt[..., 1])
    out = {prefix + "epe_all": float(err[valid].mean())}
    mat = valid & ~occ
    umat = valid & occ
    out[prefix + "epe_mat"] = float(err[mat].mean()) if mat.any() else None
    out[prefix + "epe_umat"] = float(err[umat].mean()) if umat.any() else None
    return out


def seed_flos(ds, matcher, workdir):
    """Materialise (fwd.flo, bwd.flo) for a (dataset, matcher) from the
    committed match lists; SIFT lists are generated once and committed."""
    import numpy as np

    from faldoi_tpu.core.sparse import sparse_flow
    from faldoi_tpu.io import read_flo, write_flo
    from PIL import Image

    pas, level = ds.split("/")
    base = f"{REF}/{pas}/{level}"
    with Image.open(f"{base}/frame_0002.png") as im:
        w, h = im.size
    tag = f"{pas}_{level}"
    d = os.path.join(workdir, f"{matcher}_{tag}")
    os.makedirs(d, exist_ok=True)
    f1, f2 = os.path.join(d, "mt_1.flo"), os.path.join(d, "mt_2.flo")
    if os.path.exists(f1) and os.path.exists(f2):
        return f1, f2
    if matcher == "deep":
        if ds == "clean/easy":
            for k, p in ((1, f1), (2, f2)):
                write_flo(p, read_flo(os.path.join(GOLD, f"deep_mt_{k}.flo")))
        else:
            for k, p in ((1, f1), (2, f2)):
                m = os.path.join(GOLD, "pairs", f"{tag}_mt_{k}.txt")
                write_flo(p, sparse_flow(m, w, h))
        return f1, f2
    # sift: committed cut lists, generated by the built-in matcher once
    c1 = os.path.join(GOLD, "pairs", f"sift_{tag}_mt_1.txt")
    c2 = os.path.join(GOLD, "pairs", f"sift_{tag}_mt_2.txt")
    if not (os.path.exists(c1) and os.path.exists(c2)):
        from faldoi_tpu.matchers.sift import sift_matches_files

        m1 = os.path.join(d, "raw_mt_1.txt")
        m2 = os.path.join(d, "raw_mt_2.txt")
        o1, o2 = sift_matches_files(f"{base}/frame_0002.png",
                                    f"{base}/frame_0003.png", m1, m2)
        os.replace(o1, c1)
        os.replace(o2, c2)
    for c, p in ((c1, f1), (c2, f2)):
        write_flo(p, sparse_flow(c, w, h))
    return f1, f2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/faldoi_robustness_ref")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "ROBUSTNESS_r05.jsonl"))
    ap.add_argument("--replace", action="store_true",
                    help="rewrite ROBUSTNESS.jsonl from the finished grid")
    ap.add_argument("--skip-ours", action="store_true")
    ap.add_argument("--only", default="", help="substring filter on rows")
    args = ap.parse_args()

    import numpy as np
    from PIL import Image

    from faldoi_tpu.io import read_flo

    os.makedirs(args.workdir, exist_ok=True)
    rows = []
    for ds, matcher, eps in GRID:
        key = f"{ds}/{matcher}/eps{eps}"
        if args.only and args.only not in key:
            continue
        pas, level = ds.split("/")
        base = f"{REF}/{pas}/{level}"
        gt = read_flo(f"{base}/gt/frame_0002.flo")
        occ = np.asarray(
            Image.open(f"{base}/gt/occlusions/frame_0002.png")) > 127
        invalid = np.asarray(
            Image.open(f"{base}/gt/invalid/frame_0002.png")) > 127
        s1, s2 = seed_flos(ds, matcher, args.workdir)
        d = os.path.join(args.workdir,
                         f"{matcher}_{pas}_{level}_eps{eps}")
        os.makedirs(d, exist_ok=True)
        ims = os.path.join(d, "ims.txt")
        with open(ims, "w") as fh:
            fh.write(f"{base}/frame_0002.png\n{base}/frame_0003.png\n")
        rec = {"dataset": ds, "matcher": matcher, "epsilon": eps, "vm": 0,
               "seeds": "committed"}

        # --- reference binaries -------------------------------------
        ref_var = os.path.join(d, "ref_var.flo")
        if not os.path.exists(ref_var):
            t0 = time.time()
            r1 = subprocess.run(
                [REFBUILD + "/local_faldoi", ims, s1, s2,
                 os.path.join(d, "ref_rg.flo"), os.path.join(d, "ref_sim.tiff"),
                 "-m", "0", "-fb_thresh", str(eps)],
                capture_output=True, text=True)
            r2 = subprocess.run(
                [REFBUILD + "/global_faldoi", ims,
                 os.path.join(d, "ref_rg.flo"), ref_var, "-m", "0"],
                capture_output=True, text=True)
            rec["ref_wall_s"] = round(time.time() - t0, 1)
            if r1.returncode or r2.returncode:
                rec["ref_error"] = (r1.stderr + r2.stderr)[-300:]
        if os.path.exists(ref_var):
            rec.update(epe_stats(read_flo(ref_var), gt, occ, invalid,
                                 prefix="ref_"))

        # --- ours (same seeds, same flags) --------------------------
        if not args.skip_ours:
            from faldoi_tpu.cli import local_faldoi as lcli
            from faldoi_tpu.cli import global_faldoi as gcli

            our_var = os.path.join(d, "our_var.flo")
            t0 = time.time()
            try:
                lcli.main([ims, s1, s2, os.path.join(d, "our_rg.flo"),
                           os.path.join(d, "our_sim.tiff"), "-m", "0",
                           "-fb_thresh", str(eps)])
                gcli.main([ims, os.path.join(d, "our_rg.flo"), our_var,
                           "-m", "0"])
            except Exception as e:  # keep the grid going
                rec["error"] = repr(e)[-300:]
            rec["wall_s"] = round(time.time() - t0, 1)
            if os.path.exists(our_var):
                rec.update(epe_stats(read_flo(our_var), gt, occ, invalid))

        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        rows.append(rec)

    if args.replace and rows:
        with open(os.path.join(ROOT, "ROBUSTNESS.jsonl"), "w") as fh:
            for rec in rows:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()

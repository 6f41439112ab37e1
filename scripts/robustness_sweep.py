#!/usr/bin/env python
"""FB-threshold (epsilon) robustness sweep — the JAX port of
``scripts_python/tests_robustness_epsilon.sh`` with the evaluation built in
(the reference evaluated externally in MATLAB: computeAEE_EPE, see
tests_robustness_epsilon.sh:57).

Runs the full pipeline (matcher -> sparse -> local -> global) for every
(dataset, matcher, epsilon) combination and reports, per run:

* EPE-all  — mean endpoint error vs GT over valid pixels,
* EPE-mat  — over non-occluded (matched) valid pixels,
* EPE-umat — over occluded (unmatched) valid pixels,

mirroring the MPI-Sintel protocol (gt/occlusions + gt/invalid masks).

Examples
--------
Full sweep like the reference's (hours; run on the GPU):
    python scripts/robustness_sweep.py --datasets clean/easy,clean/medium,clean/hard \
        --matchers deep --epsilons 1,2,4,8,13
Quick smoke (one pair, two epsilons, cached matches reused across runs):
    python scripts/robustness_sweep.py --datasets clean/easy --matchers deep \
        --epsilons 2,13

Results append to ROBUSTNESS.jsonl (one JSON line per run).
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


def epe_stats(est, gt, occ, invalid):
    import numpy as np

    valid = ~invalid & np.isfinite(gt[..., 0]) & np.isfinite(est[..., 0])
    err = np.hypot(est[..., 0] - gt[..., 0], est[..., 1] - gt[..., 1])
    out = {"epe_all": float(err[valid].mean())}
    mat = valid & ~occ
    umat = valid & occ
    out["epe_mat"] = float(err[mat].mean()) if mat.any() else None
    out["epe_umat"] = float(err[umat].mean()) if umat.any() else None
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default="clean/easy",
                    help="comma list of <pass>/<level> under example_data")
    ap.add_argument("--matchers", default="deep", help="deep,sift")
    ap.add_argument("--epsilons", default="2,13")
    ap.add_argument("--vm", type=int, default=0, help="energy method")
    ap.add_argument("--workdir", default="/tmp/faldoi_robustness")
    ap.add_argument("--out", default=os.path.join(ROOT, "ROBUSTNESS.jsonl"))
    args = ap.parse_args()

    import numpy as np
    from PIL import Image

    from faldoi_tpu.io import read_flo

    for ds in args.datasets.split(","):
        pas, level = ds.split("/")
        base = f"{REF}/{pas}/{level}"
        lst = f"{REF}/{pas}/sintel_one_frame_{level}.txt"
        gt = read_flo(f"{base}/gt/frame_0002.flo")
        occ = np.asarray(
            Image.open(f"{base}/gt/occlusions/frame_0002.png")) > 127
        invalid = np.asarray(
            Image.open(f"{base}/gt/invalid/frame_0002.png")) > 127
        for matcher in args.matchers.split(","):
            drv = ("faldoi_tpu.cli.faldoi_deep" if matcher == "deep"
                   else "faldoi_tpu.cli.faldoi_sift")
            for eps in args.epsilons.split(","):
                res = os.path.join(args.workdir, ds.replace("/", "_"),
                                   matcher, f"eps_{eps}")
                os.makedirs(res, exist_ok=True)
                t0 = time.time()
                cmd = [sys.executable, "-m", drv, lst, "-vm", str(args.vm),
                       "-fb_thresh", eps, "-res_path", res + "/"]
                r = subprocess.run(cmd, capture_output=True, text=True)
                wall = time.time() - t0
                rec = {"dataset": ds, "matcher": matcher,
                       "epsilon": float(eps), "vm": args.vm,
                       "wall_s": round(wall, 1)}
                var = [f for f in os.listdir(res) if f.endswith("_var.flo")]
                if var:
                    # score the artifacts whenever they exist, even if
                    # the process exited non-zero after writing them
                    est = read_flo(os.path.join(res, var[0]))
                    rec.update(epe_stats(est, gt, occ, invalid))
                    if r.returncode != 0:
                        rec["exit_note"] = "nonzero exit (teardown crash?)"
                else:
                    rec["error"] = (r.stderr or r.stdout)[-400:]
                print(json.dumps(rec), flush=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()

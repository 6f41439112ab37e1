#!/usr/bin/env python
"""Outlier visualization — the JAX port of ``scripts_python/show_outliers.sh``.

The reference script runs hard Sintel sequences x2 matchers and leaves the
outlier inspection to an external viewer; this one renders the outlier maps
directly: given an estimated ``.flo`` and the ground truth, it writes

* ``<out>_outliers.png`` — white where EPE > threshold (default 3 px, the
  usual Sintel "bad-pixel" threshold), gray where occluded, black elsewhere,
* ``<out>_epe.png`` — EPE heat map (clipped at 2x threshold),

and prints the bad-pixel fractions (all / matched / unmatched).

Run it on pipeline outputs (e.g. the robustness sweep's workdir):
    python scripts/show_outliers.py /tmp/faldoi_robustness/clean_easy/deep/eps_2/*_var.flo \
        --gt /root/reference/example_data/clean/easy/gt/frame_0002.flo \
        --occ /root/reference/example_data/clean/easy/gt/occlusions/frame_0002.png
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("flo", help="estimated flow (.flo)")
    ap.add_argument("--gt", required=True, help="ground-truth .flo")
    ap.add_argument("--occ", help="occlusion mask png (optional)")
    ap.add_argument("--invalid", help="invalid mask png (optional)")
    ap.add_argument("--thresh", type=float, default=3.0,
                    help="outlier EPE threshold in px (default 3)")
    ap.add_argument("--out", help="output prefix (default: beside the .flo)")
    args = ap.parse_args()

    from PIL import Image
    from faldoi_tpu.io import read_flo

    est = read_flo(args.flo)
    gt = read_flo(args.gt)
    occ = (np.asarray(Image.open(args.occ)) > 127) if args.occ else \
        np.zeros(gt.shape[:2], bool)
    inv = (np.asarray(Image.open(args.invalid)) > 127) if args.invalid else \
        np.zeros(gt.shape[:2], bool)

    valid = ~inv & np.isfinite(gt[..., 0]) & np.isfinite(est[..., 0])
    epe = np.hypot(est[..., 0] - gt[..., 0], est[..., 1] - gt[..., 1])
    bad = valid & (epe > args.thresh)

    vis = np.zeros(gt.shape[:2], np.uint8)
    vis[occ & valid] = 96
    vis[bad] = 255
    heat = np.clip(np.nan_to_num(epe) / (2 * args.thresh), 0, 1)

    prefix = args.out or os.path.splitext(args.flo)[0]
    Image.fromarray(vis).save(prefix + "_outliers.png")
    Image.fromarray((heat * 255).astype(np.uint8)).save(prefix + "_epe.png")

    mat, umat = valid & ~occ, valid & occ
    def frac(m):
        return float(bad[m].mean()) if m.any() else float("nan")
    print(f"bad(>{args.thresh}px): all {frac(valid):.4f}  "
          f"mat {frac(mat):.4f}  umat {frac(umat):.4f}  "
          f"epe_all {float(epe[valid].mean()):.4f}")


if __name__ == "__main__":
    sys.exit(main() or 0)

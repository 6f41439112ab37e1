"""End-to-end FALDOI driver with DeepMatching seeds — reference "Algorithm 2"
(``scripts_python/faldoi_deep.py``).  Matches come from the vendored
``deepmatching`` binary, are rescored by the structure-tensor confidence,
outlier-filtered (default threshold 0.045, the reference's corrected value)
and rasterised; the local/global steps run in-process.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

from faldoi_tpu import params as P

REF_BIN = "/root/reference/build"


def build_argparser():
    p = argparse.ArgumentParser(description="FALDOI optical flow, DeepMatching seeds")
    p.add_argument("file_images")
    p.add_argument("-vm", default="0")
    p.add_argument("-wr", default="5")
    p.add_argument("-local_iter", default=str(P.LOCAL_ITER))
    p.add_argument("-patch_iter", default=str(P.MAX_ITERATIONS_LOCAL))
    p.add_argument("-split_img", default="0")
    p.add_argument("-h_parts", default="3")
    p.add_argument("-v_parts", default="2")
    p.add_argument("-threshold", default="0.045",
                   help="outlier threshold on the DM confidence")
    p.add_argument("-fb_thresh", default=str(P.FB_TOL))
    p.add_argument("-partial_res", default="0")
    p.add_argument("-warps", default=str(P.PAR_DEFAULT_NWARPS_GLOBAL))
    p.add_argument("-glob_iter", default=str(P.MAX_ITERATIONS_GLOBAL))
    p.add_argument("-nt", default="4", help="deepmatching threads")
    p.add_argument("-downscale", default="2")
    p.add_argument("-max_scale", default=str(math.sqrt(2)))
    p.add_argument("-rot_plus", default="45")
    p.add_argument("-rot_minus", default="45")
    p.add_argument("-res_path", default="./")
    p.add_argument("-energy_params", default="")
    p.add_argument("-verbose", default="0")
    p.add_argument("-trace", default="", help="jax.profiler trace logdir")
    return p


def _dm_cmd(im0, im1, nt, downscale, max_scale, rot_minus, rot_plus):
    return [
        os.path.join(REF_BIN, "deepmatching"), im0, im1,
        "-nt", str(nt), "-downscale", str(downscale),
        "-max_scale", str(max_scale),
        "-rot_range", f"-{rot_minus}", f"+{rot_plus}",
    ]


def deepmatch_both(im0, im1, m1, m2, nt, downscale, max_scale,
                   rot_minus, rot_plus):
    """Fwd + bwd deepmatching as CONCURRENT subprocesses with the thread
    budget split between them (reference: multiprocessing.Pool with
    nt_fwd/nt_bwd, faldoi_deep.py:284-314; no gains beyond ~18 threads)."""
    nt = min(int(nt), 18)
    nt_fwd = max(nt - nt // 2, 1)
    nt_bwd = max(nt // 2, 1)
    jobs = [
        (_dm_cmd(im0, im1, nt_fwd, downscale, max_scale, rot_minus, rot_plus), m1),
        (_dm_cmd(im1, im0, nt_bwd, downscale, max_scale, rot_minus, rot_plus), m2),
    ]
    from faldoi_tpu.cli.faldoi_sift import _run_pair

    _run_pair(jobs)


def main(argv=None):
    from faldoi_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    args = build_argparser().parse_args(argv)
    verbose = args.verbose not in ("0", "false", "False")
    from faldoi_tpu.profiling import StageTimer, device_trace

    timer = StageTimer(enabled=verbose)

    from faldoi_tpu.utils import read_frame_list

    frames = read_frame_list(args.file_images)
    im0, im1 = frames[0], frames[1]

    res = args.res_path
    os.makedirs(res, exist_ok=True)
    core1 = os.path.splitext(os.path.basename(im0))[0]
    core2 = os.path.splitext(os.path.basename(im1))[0]

    from PIL import Image

    with Image.open(im1) as im:
        width_im, height_im = im.size

    m1 = os.path.join(res, f"{core1}_dm_mt_1.txt")
    m2 = os.path.join(res, f"{core2}_dm_mt_2.txt")
    with timer.stage("deepmatching"):
        deepmatch_both(im0, im1, m1, m2, args.nt, args.downscale,
                       args.max_scale, args.rot_minus, args.rot_plus)

    # confidence -> outlier filter -> 4-column cut (faldoi_deep.py:331-334)
    from faldoi_tpu.matchers import confidence_values, cut_deep_list, delete_outliers

    with timer.stage("match rescore/prune"):
        cuts = []
        for k, (a, b, m) in enumerate(((im0, im1, m1), (im1, im0, m2))):
            sal = confidence_values(a, b, m, res + os.sep)
            out = delete_outliers(sal, float(args.threshold))
            cuts.append(cut_deep_list(out))

    from faldoi_tpu.core.sparse import sparse_flow
    from faldoi_tpu.io import write_flo

    sp1 = os.path.join(res, f"{core1}_dm_mt_1.flo")
    sp2 = os.path.join(res, f"{core2}_dm_mt_2.flo")
    with timer.stage("sparse flow"):
        write_flo(sp1, sparse_flow(cuts[0], width_im, height_im))
        write_flo(sp2, sparse_flow(cuts[1], width_im, height_im))

    from faldoi_tpu.cli import local_faldoi as local_cli
    from faldoi_tpu.cli import global_faldoi as global_cli

    rg = os.path.join(res, f"{core1}_dm_rg.flo")
    sim = os.path.join(res, f"{core1}_dm_sim.tiff")
    var = os.path.join(res, f"{core1}_dm_var.flo")

    with device_trace(args.trace or None):
        with timer.stage("local step"):
            local_cli.main(
                [args.file_images, sp1, sp2, rg, sim,
                 "-m", args.vm, "-wr", args.wr, "-p", args.energy_params,
                 "-loc_it", args.local_iter, "-max_pch_it", args.patch_iter,
                 "-split_img", args.split_img, "-h_parts", args.h_parts,
                 "-v_parts", args.v_parts, "-fb_thresh", args.fb_thresh,
                 "-partial_res", args.partial_res, "-verbose", args.verbose]
            )

        with timer.stage("global step"):
            global_cli.main(
                [args.file_images, rg, var,
                 "-m", args.vm, "-w", args.warps, "-p", args.energy_params,
                 "-glb_iters", args.glob_iter, "-verbose", args.verbose]
            )
    timer.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

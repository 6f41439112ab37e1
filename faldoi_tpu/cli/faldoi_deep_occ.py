"""End-to-end FALDOI driver with occlusion estimation (method 8) —
reference ``scripts_python/faldoi_deep_occ.py``.  Requires a 4-frame input
list (I0, I1, I-1, I2); produces the flow plus occlusion masks from both the
local (``*_rg_occ.png``) and global (``*_var_occ.png``) steps.  The FB-prune
threshold default is 13 here (vs 2 for faldoi_deep; faldoi_deep_occ.py:43-49
region, scripts_python/README.txt:88-91)."""

from __future__ import annotations

import os
import sys

from faldoi_tpu import params as P
from faldoi_tpu.cli.faldoi_deep import build_argparser, deepmatch_both


def main(argv=None):
    from faldoi_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    parser = build_argparser()
    parser.set_defaults(vm="8")
    parser.set_defaults(fb_thresh="13")
    args = parser.parse_args(argv)
    verbose = args.verbose not in ("0", "false", "False")
    from faldoi_tpu.profiling import StageTimer, device_trace

    timer = StageTimer(enabled=verbose)

    from faldoi_tpu.utils import read_frame_list

    frames = read_frame_list(args.file_images)
    if len(frames) != 4:
        print("occlusion estimation needs 4 frames: I0, I1, I-1, I2",
              file=sys.stderr)
        return 1
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

    from faldoi_tpu.matchers import confidence_values, cut_deep_list, delete_outliers

    with timer.stage("match rescore/prune"):
        cuts = []
        for (a, b, m) in ((im0, im1, m1), (im1, im0, m2)):
            sal = confidence_values(a, b, m, res + os.sep)
            out = delete_outliers(sal, float(args.threshold))
            cuts.append(cut_deep_list(out))

    from faldoi_tpu.core.sparse import sparse_flow
    from faldoi_tpu.io import write_flo

    sp1 = os.path.join(res, f"{core1}_dm_mt_1.flo")
    sp2 = os.path.join(res, f"{core2}_dm_mt_2.flo")
    write_flo(sp1, sparse_flow(cuts[0], width_im, height_im))
    write_flo(sp2, sparse_flow(cuts[1], width_im, height_im))

    from faldoi_tpu.cli import local_faldoi as local_cli
    from faldoi_tpu.cli import global_faldoi as global_cli

    rg = os.path.join(res, f"{core1}_dm_rg.flo")
    sim = os.path.join(res, f"{core1}_dm_sim.tiff")
    occ_rg = os.path.join(res, f"{core1}_dm_rg_occ.png")
    var = os.path.join(res, f"{core1}_dm_var.flo")
    occ_var = os.path.join(res, f"{core1}_dm_var_occ.png")

    with device_trace(args.trace or None):
        with timer.stage("local step"):
            local_cli.main(
                [args.file_images, sp1, sp2, rg, sim, occ_rg,
                 "-m", args.vm, "-wr", args.wr, "-p", args.energy_params,
                 "-loc_it", args.local_iter, "-max_pch_it", args.patch_iter,
                 "-split_img", args.split_img, "-h_parts", args.h_parts,
                 "-v_parts", args.v_parts, "-fb_thresh", args.fb_thresh,
                 "-partial_res", args.partial_res, "-verbose", args.verbose]
            )
        with timer.stage("global step"):
            global_cli.main(
                [args.file_images, rg, var, occ_rg, occ_var,
                 "-m", args.vm, "-w", args.warps, "-p", args.energy_params,
                 "-glb_iters", args.glob_iter, "-verbose", args.verbose]
            )
    timer.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

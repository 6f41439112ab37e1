"""End-to-end FALDOI driver with SIFT seeds — reference "Algorithm 1"
(``scripts_python/faldoi_sift.py``).  Same CLI surface and artifact contract
(``*_sift_desc_*.txt`` -> ``*_sift_mt_*.txt`` -> ``*_sift_mt_*.flo`` ->
``*_sift_rg.flo`` + ``*_sift_sim.tiff`` -> ``*_sift_var.flo``), but the
pipeline stages run in-process instead of spawning binaries.

SIFT descriptors/matches come from the vendored ``sift_cli``/``match_cli``
binaries when they run on this host; otherwise the driver falls back to the
built-in pure-NumPy/JAX SIFT matcher (``faldoi_tpu.matchers.sift``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from faldoi_tpu import params as P

REF_BIN = "/root/reference/build"


def build_argparser():
    p = argparse.ArgumentParser(description="FALDOI optical flow, SIFT seeds")
    p.add_argument("file_images", help="txt file with the input frame paths")
    p.add_argument("-vm", default="0", help="variational method id (0-8)")
    p.add_argument("-wr", default="5", help="windows radius")
    p.add_argument("-local_iter", default=str(P.LOCAL_ITER))
    p.add_argument("-patch_iter", default=str(P.MAX_ITERATIONS_LOCAL))
    p.add_argument("-split_img", default="0")
    p.add_argument("-h_parts", default="3")
    p.add_argument("-v_parts", default="2")
    p.add_argument("-fb_thresh", default=str(P.FB_TOL))
    p.add_argument("-partial_res", default="0")
    p.add_argument("-warps", default=str(P.PAR_DEFAULT_NWARPS_GLOBAL))
    p.add_argument("-glob_iter", default=str(P.MAX_ITERATIONS_GLOBAL))
    p.add_argument("-nsp", default="15", help="SIFT scales per octave")
    p.add_argument("-res_path", default="./", help="output directory")
    p.add_argument("-energy_params", default="", help="9-line params file")
    p.add_argument("-verbose", default="0")
    p.add_argument("-trace", default="", help="jax.profiler trace logdir")
    return p


def _runnable(path):
    if not os.path.isfile(path):
        return False
    try:
        r = subprocess.run([path], capture_output=True, timeout=10)
        # 126/127: loader/permission failures (e.g. the vendored binaries
        # need libpng12 / newer ISAs than this host provides)
        return r.returncode not in (126, 127)
    except (OSError, subprocess.TimeoutExpired):
        return False


def _run_pair(jobs):
    """Run [(cmd, stdout_path), ...] concurrently; raise on any failure.

    All siblings are waited on (and reaped) before raising, and stdout
    handles are always closed — a mid-loop Popen failure terminates the
    already-started processes instead of orphaning them."""
    procs = []
    try:
        for cmd, out in jobs:
            fh = open(out, "w")
            try:
                procs.append((subprocess.Popen(cmd, stdout=fh), fh, cmd))
            except Exception:
                fh.close()
                raise
        rcs = [(p.wait(), cmd) for p, _fh, cmd in procs]
        for rc, cmd in rcs:
            if rc != 0:
                raise subprocess.CalledProcessError(rc, cmd)
    finally:
        for p, fh, _cmd in procs:
            if p.poll() is None:
                p.terminate()
                p.wait()
            fh.close()


def compute_sift_matches(im0, im1, nsp, res, core1, core2, verbose):
    """sift_cli x2 + match_cli x2 + column reorder (faldoi_sift.py:235-284),
    with a built-in fallback matcher when the vendored binaries can't run."""
    from faldoi_tpu.matchers.matchlists import cut_matching_list

    sift_cli = os.path.join(REF_BIN, "sift_cli")
    match_cli = os.path.join(REF_BIN, "match_cli")
    d1 = os.path.join(res, f"{core1}_sift_desc_1.txt")
    d2 = os.path.join(res, f"{core2}_sift_desc_2.txt")
    m1 = os.path.join(res, f"{core1}_sift_mt_1.txt")
    m2 = os.path.join(res, f"{core2}_sift_mt_2.txt")

    if _runnable(sift_cli):
        # fwd/bwd run as concurrent subprocesses — the reference drivers use
        # multiprocessing.Pool(2) (scripts_python/faldoi_sift.py:240-262)
        _run_pair([([sift_cli, im, "-ss_nspo", str(nsp)], d)
                   for im, d in ((im0, d1), (im1, d2))])
        _run_pair([([match_cli, a, b], m)
                   for a, b, m in ((d1, d2, m1), (d2, d1, m2))])
        return cut_matching_list(m1), cut_matching_list(m2)

    if verbose:
        print("(sift) vendored sift_cli unavailable; using built-in matcher",
              file=sys.stderr)
    from faldoi_tpu.matchers.sift import sift_matches_files

    return sift_matches_files(im0, im1, m1, m2, nspo=int(nsp))


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

    with timer.stage("sift matching"):
        cut1, cut2 = compute_sift_matches(
            im0, im1, args.nsp, res, core1, core2, verbose
        )

    # sparse seeds
    from faldoi_tpu.core.sparse import sparse_flow
    from faldoi_tpu.io import write_flo

    sp1 = os.path.join(res, f"{core1}_sift_mt_1.flo")
    sp2 = os.path.join(res, f"{core2}_sift_mt_2.flo")
    with timer.stage("sparse flow"):
        write_flo(sp1, sparse_flow(cut1, width_im, height_im))
        write_flo(sp2, sparse_flow(cut2, width_im, height_im))

    # local + global steps via the stage CLIs (shared code path)
    from faldoi_tpu.cli import local_faldoi as local_cli
    from faldoi_tpu.cli import global_faldoi as global_cli

    rg = os.path.join(res, f"{core1}_sift_rg.flo")
    sim = os.path.join(res, f"{core1}_sift_sim.tiff")
    var = os.path.join(res, f"{core1}_sift_var.flo")

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

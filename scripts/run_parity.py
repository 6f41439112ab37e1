#!/usr/bin/env python
"""End-to-end parity harness: run our pipeline and the reference binaries on
the same inputs and report EPE differences per stage.

Usage:
    python scripts/run_parity.py [--scale tiny|crop|full] [--method 0|8]

Fixtures: MPI-Sintel clean/easy frames; seeds from the cached DeepMatching
run in tests/golden/. Reference binaries must be rebuilt from source (the
prebuilt ones need libpng12 / SIGILL on foreign hosts):

    mkdir -p /tmp/shim/boost /tmp/refbuild
    # minimal boost/lexical_cast.hpp shim (std::istringstream), then:
    cd /tmp/refbuild && cmake /root/reference/src -DCMAKE_BUILD_TYPE=RELEASE \
        -DCMAKE_CXX_FLAGS=-I/tmp/shim && make

Acceptance gate (BASELINE.md): final var.flo <= 0.05 px mean EPE difference.
Validated results (2026-08-16, tiny 48x64 crop, default params):
    TVL1     var: 0.0054 px   |  TVL1+occ var: 0.0089 px
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REFBUILD = os.environ.get("FALDOI_REFBUILD", "/tmp/refbuild")
BASE = "/root/reference/example_data/clean/easy/"
GOLD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests/golden/")


def epe(a, b, mask=None):
    d = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    if mask is not None:
        d = d[mask]
    return float(np.mean(d))


def make_fixtures(scale, method, tmp):
    """Crop frames + seeds; returns (ims_txt, seed1, seed2, gt)."""
    from PIL import Image

    from faldoi_tpu.io import read_flo, write_flo

    frames = ["frame_0002.png", "frame_0003.png", "frame_0001.png",
              "frame_0004.png"]
    nframes = 4 if method == 8 else 2
    sl = {
        "tiny": np.s_[150:198, 300:364],
        "crop": np.s_[120:312, 300:556],
        "full": np.s_[0:436, 0:1024],
    }[scale]
    names = []
    for k, f in enumerate(frames[:nframes]):
        im = np.asarray(Image.open(BASE + f))[sl[0], sl[1]]
        p = os.path.join(tmp, f"f{k}.png")
        Image.fromarray(im).save(p)
        names.append(p)
    ims = os.path.join(tmp, "ims.txt")
    open(ims, "w").write("\n".join(names) + "\n")
    seeds = []
    for k in (1, 2):
        f = read_flo(GOLD + f"deep_mt_{k}.flo")[sl[0], sl[1]]
        p = os.path.join(tmp, f"mt_{k}.flo")
        write_flo(p, f)
        seeds.append(p)
    gt = read_flo(BASE + "gt/frame_0002.flo")[sl[0], sl[1]]
    return ims, seeds[0], seeds[1], gt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="tiny", choices=["tiny", "crop", "full"])
    ap.add_argument("--method", type=int, default=0)
    ap.add_argument("--workdir", default="",
                    help="persistent dir: reference outputs are cached and "
                         "reused across runs (the binaries are slow here)")
    ap.add_argument("--skip-ours", action="store_true",
                    help="only (re)generate the reference outputs")
    ap.add_argument("--verbose", action="store_true",
                    help="pass -verbose to our stage CLIs (sweep counts)")
    args = ap.parse_args()

    from faldoi_tpu.io import read_flo
    from faldoi_tpu.cli import local_faldoi as lcli
    from faldoi_tpu.cli import global_faldoi as gcli

    if args.workdir:
        tmp = args.workdir
        os.makedirs(tmp, exist_ok=True)
    else:
        tmp = tempfile.mkdtemp(prefix="faldoi_parity_")
    ims, s1, s2, gt = make_fixtures(args.scale, args.method, tmp)
    m = str(args.method)
    occ = args.method == 8

    def pth(name):
        return os.path.join(tmp, name)

    ref_local = [REFBUILD + "/local_faldoi", ims, s1, s2, pth("ref_rg.flo"),
                 pth("ref_sim.tiff")]
    ref_global = [REFBUILD + "/global_faldoi", ims, pth("ref_rg.flo"),
                  pth("ref_var.flo")]
    our_local = [ims, s1, s2, pth("our_rg.flo"), pth("our_sim.tiff")]
    our_global = [ims, pth("our_rg.flo"), pth("our_var.flo")]
    if occ:
        ref_local.append(pth("ref_rgo.png"))
        ref_global += [pth("ref_rgo.png"), pth("ref_varo.png")]
        our_local.append(pth("our_rgo.png"))
        our_global += [pth("our_rgo.png"), pth("our_varo.png")]
    if not (os.path.exists(pth("ref_rg.flo"))
            and os.path.exists(pth("ref_var.flo"))):
        subprocess.run(ref_local + ["-m", m], check=True, capture_output=True)
        subprocess.run(ref_global + ["-m", m], check=True, capture_output=True)
    if args.skip_ours:
        print("reference outputs ready in", tmp)
        return 0
    verb = ["-verbose", "1"] if args.verbose else []
    lcli.main(our_local + ["-m", m] + verb)
    gcli.main(our_global + ["-m", m] + verb)

    ok = True
    for tag in ("rg", "var"):
        o = read_flo(pth(f"our_{tag}.flo"))
        r = read_flo(pth(f"ref_{tag}.flo"))
        fin = np.isfinite(o[..., 0]) & np.isfinite(r[..., 0])
        d = epe(o, r, fin)
        print(f"m{m} {tag}: ours-vs-ref={d:.4f} "
              f"ours-gt={epe(o, gt, fin):.4f} ref-gt={epe(r, gt, fin):.4f}")
        if tag == "var" and d > 0.05:
            ok = False
    print("PARITY " + ("PASS" if ok else "FAIL") + f" (gate 0.05, {args.scale})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""CLI for the global variational refinement — drop-in contract-compatible
with the reference ``global_faldoi`` binary (``global_faldoi.cpp:1846-2213``):

    python -m faldoi_tpu.cli.global_faldoi ims.txt in_flow.flo out.flo \
        [occl_input.png occl_out.png] [-m method] [-w warps] [-p params_file] \
        [-glb_iters iters] [-verbose v]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from faldoi_tpu import params as P
from faldoi_tpu.io import read_flo, write_flo, save_image_int
from faldoi_tpu.io.image import read_image_split
from faldoi_tpu.core.preprocess import prepare_triple, read_frame_list


def pick_option(args, name, default):
    """Erase-style flag parser (utils_preprocess.cpp:21-35)."""
    flag = "-" + name
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            val = args[i + 1]
            del args[i : i + 2]
            return val
    return default


def main(argv=None):
    from faldoi_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    args = list(sys.argv[1:] if argv is None else argv)
    warps = int(pick_option(args, "w", str(P.PAR_DEFAULT_NWARPS_GLOBAL)))
    method = int(pick_option(args, "m", str(P.M_TVL1)))
    file_params = pick_option(args, "p", "")
    glb_iters = int(pick_option(args, "glb_iters", str(P.MAX_ITERATIONS_GLOBAL)))
    verbose = pick_option(args, "verbose", "0") not in ("0", "false", "False")

    if len(args) not in (3, 5):
        print(
            "usage: global_faldoi ims.txt in_flow.flo out.flo [occl_in occl_out]"
            " [-m method] [-w warps] [-p params] [-glb_iters n] [-verbose v]",
            file=sys.stderr,
        )
        return 1

    names = read_frame_list(args[0])
    in_flow = read_flo(args[1])
    outfile = args[2]
    occ_in = args[3] if len(args) == 5 else None
    occ_out = args[4] if len(args) == 5 else None

    # frame selection mirrors global_faldoi.cpp:1904-1937
    i0p = read_image_split(names[0])
    i1p = read_image_split(names[1])
    i_1p = read_image_split(names[2] if len(names) == 4 else names[1])

    # input-size validation (global_faldoi.cpp:1950-1961)
    if i1p.shape != i0p.shape or i_1p.shape != i0p.shape:
        print("ERROR: input images size mismatch", file=sys.stderr)
        return 1
    hw = i0p.shape[1:]
    if in_flow.ndim != 3 or in_flow.shape[2] != 2 or in_flow.shape[:2] != hw:
        print(
            f"ERROR: input flow field size mismatch ({in_flow.shape} vs "
            f"frames {hw})", file=sys.stderr,
        )
        return 1

    if method == P.M_TVL1_OCC and len(names) == 2:
        print(
            "Since only two images given, method is changed to TV-l2 coupled",
            file=sys.stderr,
        )
        method = P.M_TVL1

    prm = P.init_params(file_params, P.GLOBAL_STEP)
    prm.warps = warps
    prm.val_method = method
    prm.iterations_of = glb_iters
    prm.verbose = verbose

    i0n, i1n, i_1n = prepare_triple(i0p, i1p, i_1p)

    import jax.numpy as jnp

    u1 = jnp.asarray(in_flow[:, :, 0])
    u2 = jnp.asarray(in_flow[:, :, 1])

    t0 = time.time()
    from faldoi_tpu.models import global_refine

    occ0 = read_image_split(occ_in)[0] if occ_in else None
    if occ0 is not None and occ0.shape != hw:
        print("ERROR: input occlusion mask size mismatch", file=sys.stderr)
        return 1
    u1, u2, chi = global_refine(
        method, i0n, i1n, i_1n, u1, u2, prm,
        i0_planes=i0p,
        occ_init=occ0,
    )
    u1.block_until_ready()
    if verbose:
        print(f"(global) solve took {time.time() - t0:.3f}s", file=sys.stderr)

    out = np.stack([np.asarray(u1), np.asarray(u2)], axis=-1)
    write_flo(outfile, out)
    if occ_out is not None and chi is not None:
        save_image_int(occ_out, np.asarray(chi).astype(np.int32))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

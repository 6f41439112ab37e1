"""faldoi_tpu — a JAX reimplementation of the FALDOI optical-flow framework.

FALDOI (Palomares et al., JMIV 2017; IPOL 2019, doi 10.5201/ipol.2019.238)
estimates dense optical flow in five stages: sparse matching, seed
rasterisation, energy-guided local densification, and a global variational
refinement.  The upstream reference (fperezgamonal/faldoi-ipol) is a pipeline
of C/C++ executables driven by Python scripts; this package re-designs every
stage as accelerator array programs:

* all numerical kernels are dense JAX/XLA array programs (``faldoi_tpu.ops``),
* the per-patch primal-dual solvers are batched with ``vmap`` and fused by XLA
  (``faldoi_tpu.core.patch_solver``),
* the sequential priority-queue region growing is re-cast as data-parallel
  wavefront sweeps (``faldoi_tpu.core.local_step``),
* the whole-image solvers are single ``lax.scan`` programs
  (``faldoi_tpu.core.global_step``),
* multi-device scaling uses ``jax.sharding`` meshes (``faldoi_tpu.parallel``).

The file-level I/O contract (``.flo`` fields, match lists, saliency TIFFs) is
bit-compatible with the reference so that the two implementations can be
compared output-for-output.
"""

from faldoi_tpu.params import Parameters, init_params  # noqa: F401

__version__ = "0.1.0"

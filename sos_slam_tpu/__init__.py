"""sos_slam_tpu — a JAX stereo visual-inertial SLAM framework.

A from-scratch rebuild of the capabilities of SOS-SLAM (Scale Optimized Spline
SLAM, DSO lineage): direct sparse odometry over a sliding keyframe window,
stereo 1-DoF metric-scale optimization, continuous-time cubic-spline VIO, and
LiDAR-descriptor (Scan Context) loop closure with a Sim(3)/SE(3) pose graph.

Design stance (an accelerator rebuild, not a port):
  * State lives in fixed-shape arrays (padded + masked), never pointer graphs.
  * All compute paths are pure jitted functions; dynamic control flow becomes
    `lax.while_loop` / masking; per-point early exits become masked lanes.
  * Hot stages (pyramid warp + residual + H,b reduction, epipolar trace,
    Hessian/Schur accumulation) are batched XLA gathers and einsums.
  * The host driver is a thin Python layer: dataset IO, time alignment,
    loop-closure thread, `poses.txt` output.

Reference behavior parity is cited per-module as `<reference file>:<line>`.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# SLAM geometry is precision-critical: a reduced-precision matmul (bf16, or
# TF32 on the GPU's tensor cores) loses ~1e-3..1e-2 relative accuracy on pose
# compositions and Hessian products (observed: so3_exp orthogonality error
# 0.017 under bf16). Hot image ops are gathers / elementwise and unaffected;
# the small-matrix products this keeps in f32 are negligible FLOPs. Kernels
# that need it also pass explicit precision=HIGHEST.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache: the tracker/BA programs take long to compile,
# so cache them across processes. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache sits at a fixed path inside the checkout (listed in
# .gitignore), the same for every run.
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _plat = _os.environ.get("JAX_PLATFORMS", "default").replace(",", "_")
    if "cpu" in _plat:
        # key CPU entries by a host-CPU fingerprint: XLA:CPU AOT entries
        # compiled on a machine with different vector extensions SEGFAULT on
        # load (observed: avx512 builds on a narrower host), and jax's cache
        # key does not include the machine features
        import hashlib as _hl
        try:
            with open("/proc/cpuinfo") as _f:
                _flags = next((l for l in _f if l.startswith("flags")), "")
        except OSError:
            _flags = ""
        _plat += "-" + _hl.sha1(_flags.encode()).hexdigest()[:8]
    _cache = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache", _plat)
    try:
        _os.makedirs(_cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache)
    except OSError:  # read-only checkout: run without a persistent cache
        pass

from sos_slam_tpu.utils.config import Settings, default_settings  # noqa: F401

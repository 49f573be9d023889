"""Build helper for the golden-parity harnesses.

Compiles the ROS-free reference units under /root/reference with g++ against
the harness drivers in this directory (Eigen headers come from the
tensorflow wheel; Sophus is vendored in the reference). Binaries are cached
in golden/.build and rebuilt when any input is newer.

These binaries print reference-computed golden values that
tests/test_golden_parity.py compares against the JAX implementations — the
strongest reference-parity evidence available without datasets/ROS.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess

GOLDEN = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(GOLDEN, ".build")
REF = os.environ.get("SOS_REFERENCE", "/root/reference")
SRC = os.path.join(REF, "src")


def _eigen_include() -> str | None:
    spec = importlib.util.find_spec("tensorflow")
    if spec is None or not spec.submodule_search_locations:
        return None
    inc = os.path.join(list(spec.submodule_search_locations)[0], "include")
    return inc if os.path.isdir(os.path.join(inc, "Eigen")) else None


HARNESSES = {
    "sophus": ["harness_sophus.cpp"],
    "undistort": [
        "harness_undistort.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/Undistort.cpp",
        f"{SRC}/IOWrapper/ImageRW_dummy.cpp",
        f"{SRC}/IOWrapper/ImageDisplay_dummy.cpp",
    ],
    "spline": [
        "harness_spline.cpp",
        f"{SRC}/FullSystem/HessianBlocks.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/globalCalib.cpp",
    ],
    "selector": [
        "harness_selector.cpp",
        f"{SRC}/FullSystem/PixelSelector2.cpp",
        f"{SRC}/FullSystem/HessianBlocks.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/globalCalib.cpp",
        f"{SRC}/IOWrapper/ImageDisplay_dummy.cpp",
    ],
    "trace": [
        "harness_trace.cpp",
        f"{SRC}/FullSystem/ImmaturePoint.cpp",
        f"{SRC}/FullSystem/HessianBlocks.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/globalCalib.cpp",
    ],
    "residual": [
        "harness_residual.cpp",
        f"{SRC}/FullSystem/Residuals.cpp",
        f"{SRC}/FullSystem/ImmaturePoint.cpp",
        f"{SRC}/FullSystem/CoarseTracker.cpp",
        f"{SRC}/FullSystem/ScaleOptimizer.cpp",
        f"{SRC}/FullSystem/HessianBlocks.cpp",
        f"{SRC}/OptimizationBackend/EnergyFunctional.cpp",
        f"{SRC}/OptimizationBackend/EnergyFunctionalStructs.cpp",
        f"{SRC}/OptimizationBackend/AccumulatedTopHessian.cpp",
        f"{SRC}/OptimizationBackend/AccumulatedSCHessian.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/globalCalib.cpp",
        f"{SRC}/IOWrapper/ImageDisplay_dummy.cpp",
    ],
    "init": [
        "harness_init.cpp",
        f"{SRC}/FullSystem/CoarseInitializer.cpp",
        f"{SRC}/FullSystem/ScaleOptimizer.cpp",
        f"{SRC}/FullSystem/PixelSelector2.cpp",
        f"{SRC}/FullSystem/HessianBlocks.cpp",
        f"{SRC}/util/settings.cpp",
        f"{SRC}/util/globalCalib.cpp",
        f"{SRC}/IOWrapper/ImageDisplay_dummy.cpp",
    ],
    "scancontext": [
        "harness_scancontext.cpp",
        f"{SRC}/LoopClosure/ScanContext.cpp",
        f"{SRC}/util/settings.cpp",
    ],
}

# per-harness extra compile flags. scancontext: the reference stores Vec6d
# in a plain unordered_map (no aligned_allocator, ScanContext.h:65) — legal
# in its own NDEBUG Release build; additionally disable Eigen alignment so
# the debug-assert path cannot trip on the 8-byte-offset pair layout.
EXTRA_FLAGS = {
    "scancontext": ["-DNDEBUG", "-DEIGEN_MAX_ALIGN_BYTES=0"],
}


def available() -> bool:
    return (shutil.which("g++") is not None and os.path.isdir(SRC)
            and _eigen_include() is not None)


def build(name: str) -> str:
    """Compile harness `name` (cached); returns the binary path."""
    srcs = [s if os.path.isabs(s) else os.path.join(GOLDEN, s)
            for s in HARNESSES[name]]
    out = os.path.join(BUILD, f"harness_{name}")
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs):
        return out
    os.makedirs(BUILD, exist_ok=True)
    cmd = [
        "g++", "-O2", "-std=c++14", "-w", "-pthread", "-msse4.2",
        # drop unused reference functions so their (unlinked) callees —
        # ImmaturePoint, EF structs, ... — never become link errors
        "-ffunction-sections", "-fdata-sections",
        # stubs FIRST so LoopClosure/LoopHandler.h + boost/flann/g2o resolve
        # to the ROS-free shims instead of the real headers
        f"-I{os.path.join(GOLDEN, 'stubs')}",
        f"-I{_eigen_include()}",
        f"-I{REF}/thirdparty/Sophus",
        f"-I{SRC}",
        *EXTRA_FLAGS.get(name, []),
        *srcs,
        "-Wl,--gc-sections", "-o", f"{out}.tmp.{os.getpid()}",
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(f"{out}.tmp.{os.getpid()}", out)   # atomic under races
    return out


def run(name: str, *args: str) -> str:
    binary = build(name)
    res = subprocess.run([binary, *args], check=True, capture_output=True,
                         text=True, timeout=300)
    return res.stdout

"""Native host runtime: builds and binds the C++ preprocessing kernel.

Compiled lazily with g++ (ctypes binding, no pybind11 dependency); falls
back to None if no toolchain is available — callers keep the pure-Python
path in that case.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _build() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, "preprocess.cpp"),
            os.path.join(here, "scan_voxel.cpp")]
    h = hashlib.sha1()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:12]
    # built inside the checkout (listed in .gitignore), keyed by source hash
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        here))), ".native_build")
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return None
    lib_path = os.path.join(cache, f"sos_native_{tag}.so")
    if not os.path.exists(lib_path):
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
               *srcs, "-o", lib_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None

    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.preprocess_frame_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, fp, fp, fp, fp, u8p,
        ctypes.c_int, ctypes.c_int, fp]
    lib.preprocess_frame_f32.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, fp, fp, fp, fp, u8p,
        ctypes.c_int, ctypes.c_int, fp]
    dp = ctypes.POINTER(ctypes.c_double)
    lib.scan_voxel_filter.argtypes = [
        dp, u8p, ctypes.c_int, dp, ctypes.c_double, dp, i32p, dp]
    lib.scan_voxel_filter.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _build()
        _TRIED = True
    return _LIB


def preprocess_frame(raw: np.ndarray, rx: np.ndarray, ry: np.ndarray,
                     valid: np.ndarray,
                     G: Optional[np.ndarray] = None,
                     vig_inv: Optional[np.ndarray] = None
                     ) -> Optional[np.ndarray]:
    """Fused photometric + remap on the host. Returns None when the native
    library is unavailable (callers fall back to the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    h_in, w_in = raw.shape
    h, w = rx.shape
    out = np.empty((h, w), np.float32)
    rx = np.ascontiguousarray(rx, np.float32)
    ry = np.ascontiguousarray(ry, np.float32)
    validc = np.ascontiguousarray(valid, np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def f(a):
        return a.ctypes.data_as(fp)

    Gp = f(np.ascontiguousarray(G, np.float32)) if G is not None \
        else ctypes.cast(None, fp)
    Vp = f(np.ascontiguousarray(vig_inv, np.float32)) if vig_inv is not None \
        else ctypes.cast(None, fp)

    if raw.dtype == np.uint8:
        if G is None:
            G_id = np.arange(256, dtype=np.float32)
            Gp = f(G_id)
        lib.preprocess_frame_u8(
            np.ascontiguousarray(raw).ctypes.data_as(u8p), h_in, w_in,
            Gp, Vp, f(rx), f(ry), validc.ctypes.data_as(u8p), h, w, f(out))
    else:
        lib.preprocess_frame_f32(
            np.ascontiguousarray(raw, np.float32).ctypes.data_as(fp),
            h_in, w_in, Gp, Vp, f(rx), f(ry),
            validc.ctypes.data_as(u8p), h, w, f(out))
    return out


def scan_voxel_filter(pts_w: np.ndarray, valid: np.ndarray,
                      T_cw: np.ndarray, lidar_range: float,
                      inv_res: np.ndarray):
    """Native voxel keep-highest filter (process_scan_forward analog,
    ScanContext.cpp:106-178). Returns (keep_idx (M,), pts_local (M,3)) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or len(pts_w) == 0:
        return None
    n = len(pts_w)
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    pw = np.ascontiguousarray(pts_w, np.float64)
    vm = np.ascontiguousarray(valid, np.uint8)
    T = np.ascontiguousarray(T_cw, np.float64)
    ir = np.ascontiguousarray(inv_res, np.float64)
    keep = np.empty(n, np.int32)
    out = np.empty((n, 3), np.float64)
    m = lib.scan_voxel_filter(
        pw.ctypes.data_as(dp), vm.ctypes.data_as(u8p), n,
        T.ctypes.data_as(dp), ctypes.c_double(lidar_range),
        ir.ctypes.data_as(dp), keep.ctypes.data_as(i32p),
        out.ctypes.data_as(dp))
    return keep[:m].copy(), out[:m].copy()

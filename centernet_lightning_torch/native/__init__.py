"""Native (C++) host kernels of the tracker and COCO matching, with
numpy/scipy fallbacks (a copy of the JAX package's native/, which the
port may not import).

`src/native_ops.cc` is built with the system g++ on first use into a
content-addressed shared object under `centernet_lightning_torch/_build/`
and bound through ctypes. The Hungarian solver is the same code as the JAX
package's, so the same cost matrix gives the same pairing. Without the
library every consumer takes the numpy/scipy path: COCO matching is
bit-identical either way; assignment returns the same optimal total cost,
but where several optima tie (common with IoU distances) scipy may pick
another pairing. A failed build warns once, with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "set_enabled", "lap_assign", "lap_assign_or_scipy",
           "coco_match"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "native_ops.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_enabled = True


def _gxx(cmd) -> None:
    """Run one g++ command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr.strip()}")


def _compile_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"native_ops_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = ["g++", *_FLAGS, "-march=native", _SRC, "-o", tmp]
        try:
            _gxx(cmd)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            # again without -march=native, which some toolchains refuse
            cmd.remove("-march=native")
            _gxx(cmd)
        os.replace(tmp, so_path)  # atomic: safe under concurrent processes
    lib = ctypes.CDLL(so_path)
    lib.cl_lap_assign.restype = ctypes.c_int
    lib.cl_lap_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cl_coco_match.restype = None
    lib.cl_coco_match.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _enabled:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _compile_and_load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as err:
                warnings.warn(f"native_ops did not build; the tracker and COCO "
                              f"matching take the numpy/scipy paths: {err}",
                              RuntimeWarning, stacklevel=3)
    return _lib


def available() -> bool:
    """True when the compiled library is loaded (built on first call)."""
    return _get_lib() is not None


def set_enabled(flag: bool) -> None:
    """Test hook: False forces the numpy/scipy paths; True allows the
    library again (a fresh build attempt)."""
    global _enabled, _tried
    _enabled = bool(flag)
    if flag:
        _tried = False  # allow a fresh build attempt


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def lap_assign(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment over a finite rectangular cost matrix.

    Same contract as scipy.optimize.linear_sum_assignment: returns
    (row indices ascending, matched column per row), pairing min(R, C)
    rows and columns at the optimal total cost. Raises RuntimeError if the
    library is unavailable or the problem is infeasible; callers keep
    scipy as the fallback.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cost = np.ascontiguousarray(cost, np.float64)
    r, c = cost.shape
    if r == 0 or c == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    transpose = r > c
    a = np.ascontiguousarray(cost.T) if transpose else cost
    n, m = a.shape
    col4row = np.empty(n, np.int32)
    rc = lib.cl_lap_assign(_ptr(a, ctypes.c_double), n, m,
                           _ptr(col4row, ctypes.c_int))
    if rc != 0:
        raise RuntimeError("infeasible assignment (non-finite costs?)")
    rows = np.arange(n, dtype=np.int64)
    cols = col4row.astype(np.int64)
    if transpose:
        rows, cols = cols, rows
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
    return rows, cols


def coco_match(ious: np.ndarray, iou_thrs: np.ndarray, gt_ig: np.ndarray,
               gt_crowd: np.ndarray) -> Optional[np.ndarray]:
    """COCOeval greedy matching over (D, G) IoUs at T thresholds.

    Returns dtm (T, D) int64 (matched GT index + 1, 0 for unmatched), or
    None when the library is unavailable (the caller runs its numpy loop).
    """
    lib = _get_lib()
    if lib is None:
        return None
    ious = np.ascontiguousarray(ious, np.float64)
    d, g = ious.shape
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    t = len(thrs)
    dtm = np.zeros((t, d), np.int64)
    if d == 0 or g == 0:
        return dtm
    gt_ig = np.ascontiguousarray(gt_ig, np.uint8)
    gt_crowd = np.ascontiguousarray(gt_crowd, np.uint8)
    lib.cl_coco_match(_ptr(ious, ctypes.c_double), d, g,
                      _ptr(thrs, ctypes.c_double), t,
                      _ptr(gt_ig, ctypes.c_ubyte),
                      _ptr(gt_crowd, ctypes.c_ubyte),
                      _ptr(dtm, ctypes.c_longlong))
    return dtm


def lap_assign_or_scipy(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """lap_assign, or scipy's linear_sum_assignment for non-finite costs or
    without the library: a drop-in for the latter on minimisation."""
    cost = np.asarray(cost, np.float64)
    if np.isfinite(cost).all() and available():
        try:
            return lap_assign(cost)
        except RuntimeError:
            pass
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)

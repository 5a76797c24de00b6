"""ctypes binding for the native binned-SAH BVH builder."""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is None:
        from mcpt.native.build import ensure_built

        _lib = ctypes.CDLL(ensure_built())
        _lib.mcpt_build_bvh.restype = ctypes.c_int64
        _lib.mcpt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
    return _lib


def build_bvh_native(v0, e1, e2, leaf_size: int):
    """Binned-SAH build -> ({lo,hi,first,count,skip}, perm). See ops/bvh.py."""
    lib = _load()
    v0 = np.ascontiguousarray(v0, np.float64)
    e1 = np.ascontiguousarray(e1, np.float64)
    e2 = np.ascontiguousarray(e2, np.float64)
    T = v0.shape[0]
    cap = 2 * T
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = lib.mcpt_build_bvh(
        ptr(v0, ctypes.c_double),
        ptr(e1, ctypes.c_double),
        ptr(e2, ctypes.c_double),
        T,
        leaf_size,
        ptr(lo, ctypes.c_float),
        ptr(hi, ctypes.c_float),
        ptr(first, ctypes.c_int32),
        ptr(count, ctypes.c_int32),
        ptr(skip, ctypes.c_int32),
        ptr(perm, ctypes.c_int64),
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (rc={n})")
    nodes = {
        "lo": lo[:n].copy(),
        "hi": hi[:n].copy(),
        "first": first[:n].copy(),
        "count": count[:n].copy(),
        "skip": skip[:n].copy(),
    }
    return nodes, perm

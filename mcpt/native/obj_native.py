"""ctypes binding for the native OBJ parser (reference src/model.cpp:44-156
semantics: v/vn/vt/f/usemtl, 1-based indices, triangle-fan for polygons)."""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is None:
        from mcpt.native.build import ensure_built

        _lib = ctypes.CDLL(ensure_built())
        P = ctypes.POINTER
        _lib.mcpt_parse_obj.restype = ctypes.c_int
        _lib.mcpt_parse_obj.argtypes = [
            ctypes.c_char_p,
            P(P(ctypes.c_double)), P(ctypes.c_int64),
            P(P(ctypes.c_double)), P(ctypes.c_int64),
            P(P(ctypes.c_double)), P(ctypes.c_int64),
            P(P(ctypes.c_int32)), P(ctypes.c_int64),
            P(P(ctypes.c_char)), P(ctypes.c_int64),
        ]
        _lib.mcpt_free.argtypes = [ctypes.c_void_p]
    return _lib


def parse_obj(path: str, material_map: dict):
    """Parse an OBJ -> (verts, norms, uvs, faces[T,3,4]) numpy arrays.

    Face material slots (order of first usemtl appearance) are remapped to
    the global material indices via `material_map` (name -> index).
    """
    lib = _load()
    P = ctypes.POINTER
    verts_p = P(ctypes.c_double)()
    norms_p = P(ctypes.c_double)()
    uvs_p = P(ctypes.c_double)()
    faces_p = P(ctypes.c_int32)()
    names_p = P(ctypes.c_char)()
    nv = ctypes.c_int64()
    nn = ctypes.c_int64()
    nt = ctypes.c_int64()
    nf = ctypes.c_int64()
    nl = ctypes.c_int64()
    rc = lib.mcpt_parse_obj(
        path.encode(),
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(norms_p), ctypes.byref(nn),
        ctypes.byref(uvs_p), ctypes.byref(nt),
        ctypes.byref(faces_p), ctypes.byref(nf),
        ctypes.byref(names_p), ctypes.byref(nl),
    )
    if rc != 0:
        raise IOError(f"native OBJ parse failed for {path} (rc={rc})")

    def take(ptr, n, dtype, cols):
        if n == 0:
            arr = np.zeros((0, cols), dtype)
        else:
            arr = np.ctypeslib.as_array(ptr, shape=(n * cols,)).astype(dtype, copy=True)
            arr = arr.reshape(n, cols)
        lib.mcpt_free(ptr)
        return arr

    verts = take(verts_p, nv.value, np.float64, 3)
    norms = take(norms_p, nn.value, np.float64, 3)
    uvs = take(uvs_p, nt.value, np.float64, 2)
    faces_flat = take(faces_p, nf.value, np.int32, 12)
    faces = faces_flat.reshape(-1, 3, 4)

    names_raw = ctypes.string_at(names_p, nl.value).decode() if nl.value else ""
    lib.mcpt_free(names_p)
    slot_names = names_raw.split("\n") if names_raw else []
    # remap slot -> global material index (unknown names -> 0, matching the
    # reference's defaulted material_map lookup, model.cpp:135)
    remap = np.array(
        [material_map.get(n, 0) for n in slot_names] or [0], dtype=np.int32
    )
    slots = np.clip(faces[:, :, 3], 0, len(remap) - 1)
    faces[:, :, 3] = remap[slots]
    return verts, norms, uvs, faces

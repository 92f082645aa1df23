"""ctypes binding to the repository's native host library
(native/libgoblin_native.so): binned-SAH BVH builder and OBJ parser.

Port of goblin_tpu/native.py's loader and the two calls the port uses.
Each call returns None when the library cannot be loaded or built
(``make -C native``); callers then take their Python fallbacks.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "libgoblin_native.so",
)


@functools.cache
def _lib():
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(_LIB_PATH)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.goblin_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, i32p,
    ]
    lib.goblin_build_bvh.restype = ctypes.c_int
    lib.goblin_obj_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.goblin_obj_parse.restype = ctypes.c_int64
    lib.goblin_obj_fill.argtypes = [ctypes.c_int64, f32p, f32p, f32p, i32p]
    lib.goblin_obj_fill.restype = None
    return lib


def build_bvh(v0, v1, v2, max_leaf=4, n_bins=16):
    """Native BVH build -> (bounds, meta, order), or None."""
    lib = _lib()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    T = v0.shape[0]
    cap = 2 * T + 1
    bounds = np.empty((cap, 6), np.float32)
    meta = np.empty((cap, 3), np.int32)
    order = np.empty(T, np.int32)
    n = lib.goblin_build_bvh(v0, v1, v2, T, max_leaf, n_bins, bounds, meta,
                             order)
    if n <= 0:
        return None
    return bounds[:n].copy(), meta[:n].copy(), order


def load_obj(path: str):
    """Native OBJ parse -> (positions, normals|None, uvs|None, faces), or
    None."""
    lib = _lib()
    if lib is None:
        return None
    nv, nf, hn, hu = (ctypes.c_int() for _ in range(4))
    h = lib.goblin_obj_parse(path.encode(), ctypes.byref(nv), ctypes.byref(nf),
                             ctypes.byref(hn), ctypes.byref(hu))
    if h == 0:
        return None
    pos = np.empty((nv.value, 3), np.float32)
    nrm = np.empty((nv.value, 3), np.float32)
    uv = np.empty((nv.value, 2), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.goblin_obj_fill(h, pos, nrm, uv, faces)
    return pos, (nrm if hn.value else None), (uv if hu.value else None), faces

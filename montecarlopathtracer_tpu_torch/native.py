"""The repository's native host runtime, loaded for the port.

``native/mcpt_native.cpp`` (a C++ OBJ/MTL parser and KD-tree construction
with a plain C interface) is compiled, unchanged, with the system
``g++`` into ``build/torch_kernels/mcpt_native-<hash>.so`` at first use,
named by a hash of the source and the flags, and bound with
:mod:`ctypes` (ABI version 2). This module is the port's counterpart of
``montecarlopathtracer_tpu/native/__init__.py``; it never loads that
package's library.

- :func:`read_obj_native`: an OBJ file into the port's
  :class:`..scene.objio.ObjModel`, equal to the pure-Python parser's;
- :func:`build_kdtree_native`: the KD build and its pre-order skip-link
  flattening in one call, equal to
  ``flatten_kdtree(build_kdtree(...))`` of :mod:`.accel.kdtree`;
- :func:`available` says whether the library built; :func:`build_error`
  why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mcpt_native.cpp"
ABI_VERSION = 2
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def build() -> Path:
    """Compile the source unless its build exists; returns the library's
    path or raises."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native source not found: {SOURCE}")
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"mcpt_native-{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ invocation failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp = ctypes.c_void_p
    lib.mcpt_abi_version.restype = ctypes.c_int
    lib.mcpt_obj_read.restype = vp
    lib.mcpt_obj_read.argtypes = [ctypes.c_char_p]
    lib.mcpt_obj_error.restype = ctypes.c_char_p
    lib.mcpt_obj_error.argtypes = [vp]
    lib.mcpt_obj_counts.argtypes = [vp] + [i64p] * 8
    lib.mcpt_obj_fill.argtypes = [vp] * 17
    lib.mcpt_obj_free.argtypes = [vp]
    lib.mcpt_kd_build.restype = vp
    lib.mcpt_kd_build.argtypes = [vp] * 4 + [ctypes.c_int64]
    lib.mcpt_kd_counts.argtypes = [vp, i64p, i64p]
    lib.mcpt_kd_fill.argtypes = [vp] * 7
    lib.mcpt_kd_free.argtypes = [vp]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built at first use), or None if it cannot be
    built or loaded; :func:`build_error` says why."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                version = lib.mcpt_abi_version()
                if version != ABI_VERSION:
                    raise RuntimeError(f"ABI version {version}, expected {ABI_VERSION}")
                _lib = lib
            except (OSError, RuntimeError) as e:
                _error = str(e)
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _error


def _lib_or_raise() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def read_obj_native(path: str):
    """Parse an OBJ (+ MTL) file with the C++ parser into an
    :class:`..scene.objio.ObjModel` (the same pools as the Python
    parser's, dummy index-0 entries included)."""
    from .scene.objio import ObjMaterial, ObjModel, ObjTriangle

    lib = _lib_or_raise()
    handle = lib.mcpt_obj_read(path.encode())
    if not handle:
        raise RuntimeError("mcpt_obj_read returned NULL")
    try:
        err = lib.mcpt_obj_error(handle)
        if err:
            raise FileNotFoundError(err.decode())
        counts = [ctypes.c_int64() for _ in range(8)]
        lib.mcpt_obj_counts(handle, *[ctypes.byref(c) for c in counts])
        nv, nt, nn, ntri, nmat, ngroups, gtotal, nbytes = (c.value for c in counts)
        arrays = dict(
            vertices=np.empty((nv, 3)), textures=np.empty((nt, 2)), normals=np.empty((nn, 3)),
            tri_v=np.empty((ntri, 3), np.int32), tri_t=np.empty((ntri, 3), np.int32),
            tri_n=np.empty((ntri, 3), np.int32), tri_mat=np.empty((ntri,), np.int32),
            mat_ka=np.empty((nmat, 3)), mat_kd=np.empty((nmat, 3)), mat_ks=np.empty((nmat, 3)),
            mat_ns=np.empty((nmat,)), mat_tr=np.empty((nmat,)), mat_ni=np.empty((nmat,)),
            group_start=np.empty((ngroups + 1,), np.int64),
            group_tris=np.empty((gtotal,), np.int32),
        )
        names = ctypes.create_string_buffer(int(nbytes))
        lib.mcpt_obj_fill(handle, *(_ptr(a) for a in arrays.values()),
                          ctypes.cast(names, ctypes.c_void_p))
    finally:
        lib.mcpt_obj_free(handle)

    a = arrays
    name_list = bytes(names.raw).split(b"\0")[: ngroups + nmat]
    group_names = [n.decode() for n in name_list[:ngroups]]
    mat_names = [n.decode() for n in name_list[ngroups:]]
    model = ObjModel(path=path)
    model.vertices = [tuple(map(float, v)) for v in a["vertices"]]
    model.textures = [tuple(map(float, t)) for t in a["textures"]]
    model.normals = [tuple(map(float, n)) for n in a["normals"]]
    model.triangles = [
        ObjTriangle(v=tuple(int(x) for x in a["tri_v"][i]), t=tuple(int(x) for x in a["tri_t"][i]),
                    n=tuple(int(x) for x in a["tri_n"][i]), material=int(a["tri_mat"][i]))
        for i in range(ntri)
    ]
    model.materials = [
        ObjMaterial(name=mat_names[i], Ka=tuple(map(float, a["mat_ka"][i])),
                    Kd=tuple(map(float, a["mat_kd"][i])), Ks=tuple(map(float, a["mat_ks"][i])),
                    Ns=float(a["mat_ns"][i]), Tr=float(a["mat_tr"][i]), Ni=float(a["mat_ni"][i]))
        for i in range(nmat)
    ]
    gs, gt = a["group_start"], a["group_tris"]
    model.groups = {group_names[g]: [int(t) for t in gt[gs[g]:gs[g + 1]]]
                    for g in range(ngroups)}
    return model


def build_kdtree_native(a, b, c, valid=None, pad_leaf_to: int = 1):
    """Build and flatten the KD tree of the triangle soup ``a``, ``b``,
    ``c`` f32[T, 3] (``valid`` bool[T] masks out padding triangles) with
    the C++ code: a :class:`.accel.kdtree.FlatKDTree` equal to the
    Python construction's."""
    from .accel.kdtree import FlatKDTree

    lib = _lib_or_raise()
    a, b, c = (np.ascontiguousarray(x, np.float32) for x in (a, b, c))
    vmask = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    handle = lib.mcpt_kd_build(_ptr(a), _ptr(b), _ptr(c),
                               None if vmask is None else _ptr(vmask), a.shape[0])
    if not handle:
        raise RuntimeError("mcpt_kd_build returned NULL")
    try:
        n_nodes, n_leaf = ctypes.c_int64(), ctypes.c_int64()
        lib.mcpt_kd_counts(handle, ctypes.byref(n_nodes), ctypes.byref(n_leaf))
        N, L = n_nodes.value, n_leaf.value
        flat = FlatKDTree(
            node_lo=np.empty((N, 3), np.float32), node_hi=np.empty((N, 3), np.float32),
            node_skip=np.empty((N,), np.int32), leaf_start=np.empty((N,), np.int32),
            leaf_count=np.empty((N,), np.int32), leaf_tris=np.empty((L,), np.int32),
        )
        lib.mcpt_kd_fill(handle, _ptr(flat.node_lo), _ptr(flat.node_hi), _ptr(flat.node_skip),
                         _ptr(flat.leaf_start), _ptr(flat.leaf_count), _ptr(flat.leaf_tris))
    finally:
        lib.mcpt_kd_free(handle)
    if pad_leaf_to > 1 and L % pad_leaf_to:
        pad = pad_leaf_to - L % pad_leaf_to
        flat.leaf_tris = np.concatenate([flat.leaf_tris, np.full((pad,), -1, np.int32)])
    return flat

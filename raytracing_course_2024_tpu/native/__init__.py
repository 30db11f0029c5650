"""Native (C++) host-runtime components, loaded via ctypes.

The compute path is JAX/XLA/Pallas on the accelerator; the host-side heavy
lifting -- today the binned-SAH BVH build over 100k+ primitives -- is C++
(the reference's equivalent is its Rust build, src/bvh.rs:26-144). The
shared library is compiled on first use with g++ (plain C ABI + ctypes) and
cached under the user cache directory; any failure falls back to
the numpy builder in ops/bvh.py, which is also the correctness oracle for
tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import sys
import threading

import numpy as np

log = logging.getLogger("rt")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_lock = threading.Lock()
_lib_cache = None


def _so_path() -> str:
    """Cache path keyed by (source hash, host) -- the binary is built with
    -march=native, so it must never be shared across CPU types (a committed
    .so could SIGILL in-process on a different host)."""
    override = os.environ.get("RT_NATIVE_SO")
    if override:
        return override
    with open(_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = f"{src_hash}-{platform.machine()}-{platform.node()}"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    d = os.path.join(cache, "rt_native")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"librt_native-{tag}.so")


def _compile(so: str) -> str:
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", so, _SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return so


def _selftest(so: str) -> bool:
    """Exercise rt_build_bvh in a THROWAWAY subprocess first: an
    incompatible binary dies there (SIGILL etc.) instead of killing us."""
    code = (
        "import ctypes,numpy as np;"
        f"lib=ctypes.CDLL({so!r});"
        "n=2;f64=ctypes.POINTER(ctypes.c_double);f32=ctypes.POINTER(ctypes.c_float);"
        "i32=ctypes.POINTER(ctypes.c_int32);u8=ctypes.POINTER(ctypes.c_uint8);"
        "lib.rt_build_bvh.restype=ctypes.c_int64;"
        "amin=np.zeros((n,3));amax=np.ones((n,3));"
        "po=np.empty(n,np.int32);nm=np.empty((4,3),np.float32);nx=np.empty((4,3),np.float32);"
        "nl=np.empty(4,np.int32);nr=np.empty(4,np.int32);lf=np.empty(4,np.uint8);"
        "c=lib.rt_build_bvh(amin.ctypes.data_as(f64),amax.ctypes.data_as(f64),"
        "ctypes.c_int64(n),4,16,po.ctypes.data_as(i32),nm.ctypes.data_as(f32),"
        "nx.ctypes.data_as(f32),nl.ctypes.data_as(i32),nr.ctypes.data_as(i32),"
        "lf.ctypes.data_as(u8),ctypes.c_int64(4));"
        "assert c>0"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, timeout=60)
    return r.returncode == 0


def load_native():
    global _lib_cache
    with _lock:
        if _lib_cache is not None:
            return _lib_cache
        so = _so_path()
        fresh = False
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
            _SRC
        ):
            _compile(so)
            fresh = True
        if fresh and not _selftest(so):
            raise RuntimeError(f"native self-test failed for {so}")
        lib = ctypes.CDLL(so)
        lib.rt_build_bvh.restype = ctypes.c_int64
        lib.rt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # amin
            ctypes.POINTER(ctypes.c_double),  # amax
            ctypes.c_int64,  # n
            ctypes.c_int32,  # leaf_size
            ctypes.c_int32,  # num_bins
            ctypes.POINTER(ctypes.c_int32),  # prim_order
            ctypes.POINTER(ctypes.c_float),  # node_min
            ctypes.POINTER(ctypes.c_float),  # node_max
            ctypes.POINTER(ctypes.c_int32),  # node_left
            ctypes.POINTER(ctypes.c_int32),  # node_right
            ctypes.POINTER(ctypes.c_uint8),  # node_is_leaf
            ctypes.c_int64,  # max_nodes
        ]
        _lib_cache = lib
        return lib


def native_build_bvh(amin: np.ndarray, amax: np.ndarray, leaf_size: int,
                     num_bins: int):
    """C++ binned-SAH build; returns the same _HostBvh as ops.bvh.build_bvh."""
    from ..ops.bvh import _HostBvh

    lib = load_native()
    n = amin.shape[0]
    amin = np.ascontiguousarray(amin, np.float64)
    amax = np.ascontiguousarray(amax, np.float64)
    max_nodes = max(2 * n, 2)
    prim_order = np.empty(n, np.int32)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_left = np.empty(max_nodes, np.int32)
    node_right = np.empty(max_nodes, np.int32)
    node_is_leaf = np.empty(max_nodes, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    count = lib.rt_build_bvh(
        p(amin, ctypes.c_double),
        p(amax, ctypes.c_double),
        n,
        leaf_size,
        num_bins,
        p(prim_order, ctypes.c_int32),
        p(node_min, ctypes.c_float),
        p(node_max, ctypes.c_float),
        p(node_left, ctypes.c_int32),
        p(node_right, ctypes.c_int32),
        p(node_is_leaf, ctypes.c_uint8),
        max_nodes,
    )
    if count <= 0:
        raise RuntimeError(f"rt_build_bvh failed: {count}")
    return _HostBvh(
        node_min=node_min[:count],
        node_max=node_max[:count],
        node_left=node_left[:count],
        node_right=node_right[:count],
        node_is_leaf=node_is_leaf[:count].astype(bool),
        prim_order=prim_order,
    )


__all__ = ["load_native", "native_build_bvh"]

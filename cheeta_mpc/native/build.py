"""Build + load the native transport library (ctypes, no pybind11)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "policy_bus.cpp")
_SHM_SRC = os.path.join(os.path.dirname(__file__), "shm_bus.cpp")
_CACHE_DIR = os.environ.get("CHEETA_NATIVE_CACHE",
                            os.path.expanduser("~/.cache/cheeta_mpc"))
_lock = threading.Lock()
_lib = None
_shm_lib = None


def _build(src: str, stem: str, extra=()) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_CACHE_DIR, exist_ok=True)
    so_path = os.path.join(_CACHE_DIR, f"{stem}-{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp.{os.getpid()}"
        subprocess.check_call([
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
            src, "-o", tmp] + list(extra))
        os.replace(tmp, so_path)
    return so_path


def load_policy_bus() -> ctypes.CDLL:
    """Compile (once, content-hashed cache) and load the bus library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build(_SRC, "libpolicybus"))
        lib.bus_create.restype = ctypes.c_void_p
        lib.bus_create.argtypes = [ctypes.c_int]
        lib.bus_destroy.argtypes = [ctypes.c_void_p]
        lib.bus_publish.restype = ctypes.c_int64
        lib.bus_publish.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_uint32]
        lib.bus_consume.restype = ctypes.c_int64
        lib.bus_consume.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_uint32)]
        lib.bus_wait.restype = ctypes.c_int64
        lib.bus_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_uint64, ctypes.c_int]
        lib.bus_seq.restype = ctypes.c_uint64
        lib.bus_seq.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def load_shm_bus() -> ctypes.CDLL:
    """Compile (once) and load the cross-process shared-memory bus."""
    global _shm_lib
    with _lock:
        if _shm_lib is not None:
            return _shm_lib
        lib = ctypes.CDLL(_build(_SHM_SRC, "libshmbus", extra=("-lrt",)))
        lib.shm_bus_create.restype = ctypes.c_void_p
        lib.shm_bus_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_uint32]
        lib.shm_bus_attach.restype = ctypes.c_void_p
        lib.shm_bus_attach.argtypes = [ctypes.c_char_p]
        lib.shm_bus_close.argtypes = [ctypes.c_void_p]
        lib.shm_bus_unlink.restype = ctypes.c_int
        lib.shm_bus_unlink.argtypes = [ctypes.c_char_p]
        lib.shm_bus_ntopics.restype = ctypes.c_int
        lib.shm_bus_ntopics.argtypes = [ctypes.c_void_p]
        lib.shm_bus_capacity.restype = ctypes.c_uint32
        lib.shm_bus_capacity.argtypes = [ctypes.c_void_p]
        lib.shm_bus_publish.restype = ctypes.c_int64
        lib.shm_bus_publish.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_uint32]
        lib.shm_bus_consume.restype = ctypes.c_int64
        lib.shm_bus_consume.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_uint32,
                                        ctypes.POINTER(ctypes.c_uint32)]
        lib.shm_bus_wait.restype = ctypes.c_int64
        lib.shm_bus_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.shm_bus_seq.restype = ctypes.c_uint64
        lib.shm_bus_seq.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _shm_lib = lib
        return lib

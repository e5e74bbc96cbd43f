"""Build and load the consensus-reward library (``creward.cpp``, ctypes).

Compiled with g++ at first use into ``rl/_build/`` (git-ignored), named by
a hash of the source, so an edited source rebuilds. A failed build or load
raises with the compiler's output: a caller that asked for the native
scorer never gets the Python one instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "creward.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.crw_create.restype = ctypes.c_void_p
    lib.crw_create.argtypes = [ctypes.c_double, ctypes.c_double,
                               ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.crw_free.argtypes = [ctypes.c_void_p]
    lib.crw_set_df.argtypes = [ctypes.c_void_p, i32p, i32p, f64p,
                               ctypes.c_int64]
    lib.crw_add_video.restype = ctypes.c_int32
    lib.crw_add_video.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int32]
    lib.crw_score.argtypes = [
        ctypes.c_void_p, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, f32p,
    ]
    return lib


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcreward-{digest[:16]}.so"


def load_creward() -> ctypes.CDLL:
    """The reward library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"g++ failed for creward.cpp:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)   # atomic: a reader never sees a partial file
        _lib = _bind(ctypes.CDLL(str(path)))
        return _lib

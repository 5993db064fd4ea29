"""ctypes binding to the native host resampler (the repo's
``native/dass_native.cpp``; parity: the JAX package's data/native.py).

The C++ library reproduces Pillow's two-pass fixed-point BILINEAR resize
and its NEAREST resize bit for bit, with OpenMP across rows, and a
crop-window form that computes only the pixels of a window of the resized
image (bit-equal to resize-then-crop). ``data/transforms.py`` routes every
bilinear and nearest resize of the Loaders through it; PIL stays as the
plain version (``transforms.imresize_plain``), which the tests call
explicitly.

The library is built at first use with ``g++ -O3 -march=native -fopenmp
-shared -fPIC`` into this package's git-ignored ``_build/``, under a name
that carries a hash of the source and the flags (as ``cuda_build`` names
the CUDA kernels), so an edited source is never served a stale build. The
build writes a temporary name and renames it into place under a file lock,
so processes that start together build once. A failed build raises with
the compiler's message: there is no fallback and no switch.

``set_num_threads`` sets the OpenMP threads of the calls made after it,
in whatever thread makes them (the count is applied before every call,
since OpenMP keeps the setting per calling thread); by default a call
uses OpenMP's own count at load time (every core unless
``OMP_NUM_THREADS`` says otherwise). The tests pin it to one, as they
pin torch's intra-op pool.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "dass_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_num_threads: Optional[int] = None


def library_path() -> Path:
    """``BUILD_DIR/libdass_native-<hash of SOURCE and FLAGS>.so``."""
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdass_native-{tag}.so"


def build() -> Path:
    """The library of ``SOURCE``, compiled unless a current build exists.
    Raises ``RuntimeError`` with the compiler's output when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one process builds; the others wait
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native resampler build failed (g++ exited "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: no process loads half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            ints = [ctypes.c_int] * 3
            for name in ("resize_bilinear_u8_window", "resize_nearest_u8_window"):
                fn = getattr(lib, name)
                fn.argtypes = [u8p, *ints, u8p, *[ctypes.c_int] * 6]
                fn.restype = None
            lib.omp_set_num_threads.argtypes = [ctypes.c_int]
            lib.omp_set_num_threads.restype = None
            lib.omp_get_max_threads.restype = ctypes.c_int
            lib.default_threads = lib.omp_get_max_threads()
            _lib = lib
        return _lib


def set_num_threads(n: Optional[int]) -> None:
    """Run later calls on ``n`` OpenMP threads (None: OpenMP's own count at
    load time)."""
    global _num_threads
    if n is not None and n < 1:
        raise ValueError(f"thread count {n}")
    _num_threads = n


def get_num_threads() -> Optional[int]:
    return _num_threads


def resize_u8_window(arr: np.ndarray, oh: int, ow: int, x0: int, y0: int,
                     ww: int, wh: int, interp: str = "bilinear") -> np.ndarray:
    """The window [y0:y0+wh, x0:x0+ww] of the PIL-identical (oh, ow)
    resize of the uint8 (H, W) or (H, W, C) ``arr``, computed without the
    pixels outside it."""
    if interp not in ("bilinear", "nearest"):
        raise ValueError(f"the native resampler has no '{interp}' mode")
    if not (0 <= x0 and 0 <= y0 and ww > 0 and wh > 0
            and x0 + ww <= ow and y0 + wh <= oh):
        raise ValueError(f"window ({x0},{y0},{ww},{wh}) outside ({oh},{ow})")
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(f"uint8 (H, W[, C]) image expected, got "
                         f"{arr.dtype} {arr.shape}")
    arr = np.ascontiguousarray(arr)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    h, w, c = arr.shape
    out = np.empty((wh, ww, c), np.uint8)
    lib = get_lib()
    fn = (lib.resize_bilinear_u8_window if interp == "bilinear"
          else lib.resize_nearest_u8_window)
    lib.omp_set_num_threads(_num_threads or lib.default_threads)
    fn(arr, h, w, c, out, oh, ow, x0, y0, ww, wh)
    return out[..., 0] if squeeze else out


def resize_u8(arr: np.ndarray, oh: int, ow: int,
              interp: str = "bilinear") -> np.ndarray:
    """PIL-identical (oh, ow) resize of the uint8 (H, W[, C]) ``arr``."""
    return resize_u8_window(arr, oh, ow, 0, 0, ow, oh, interp)

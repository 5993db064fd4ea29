"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
(git-ignored) at first use, and loaded with ``ctypes``; no PyTorch headers
are involved, so a build takes seconds. Library names carry a hash of the
source and the flags, so an edited source is never served a stale build,
and the sources of another checkout (``csrc``, to time an older design
beside this one) build into the same directory without a clash. Builds
run under a file lock in ``_build/``: of the ranks of a data-parallel
run that start together, the first builds and the others wait for it
and load what it built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("upsample_argmax", "tconv_votes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA toolkit's nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str, csrc: Path = CSRC_DIR) -> Path:
    src = (Path(csrc) / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = SOURCES, csrc: Path = CSRC_DIR) -> Dict[str, str]:
    """Compile every named source in ``csrc`` that has no current library,
    one nvcc process per source, all started together. Returns each
    compiled source's compiler output (ptxas register and spill report).
    Processes that build at once take turns (a file lock), so a library
    one of them built is not built again."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "cuda.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_unlocked(names, csrc)


def _build_unlocked(names, csrc: Path) -> Dict[str, str]:
    procs = {}
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """The loaded library for ``<csrc>/<name>.cu``, built at first use."""
    with _lock:
        path = library_path(name, csrc)
        lib = _libs.get(path)
        if lib is None:
            if not path.exists():
                build([name], csrc)
            lib = ctypes.CDLL(str(path))
            _libs[path] = lib
        return lib

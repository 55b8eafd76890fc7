"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``.

The build happens at the first launch, never at import: the CPU tests import
every module on a machine with no ``nvcc``. Each source under ``csrc/``
becomes ``lib<name>-<hash>.so`` in the build directory — ``build/kernels/``
at the root of the checkout, or the server's ``compilation_cache_dir``
(``set_build_dir``);
the hash covers every file under ``csrc/`` and the flags, so an edit rebuilds
and an unchanged tree reuses the library (``.gitignore`` lists ``build/``).
The library is written under a temporary name and renamed into place, so two
processes building at once (a test and the server it starts) never load a
half-written file. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def set_build_dir(path: "str | Path") -> None:
    """Build into and load from ``path`` (process-wide, like the reference's
    persistent compilation cache): libraries built there before are reused,
    so a process that finds its kernels built loads them without ``nvcc``."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building it first if
    this source tree has not been built yet."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.exists():
            build(name, so)
        lib = _loaded[name] = ctypes.CDLL(str(so))
        return lib


def build(name: str, so: Path) -> None:
    """Compile ``csrc/<name>.cu`` into ``so``; the compiler's report (ptxas
    registers, shared memory, spills) is kept beside it as ``<so>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    so.with_name(so.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)

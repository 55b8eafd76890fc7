"""ctypes binding for the native JPEG -> YUV 4:2:0 decode shim, the port's
own copy of ``tpuserve/native.py``.

The shim (the repo's ``native/decode/jpegyuv.c``, plain C over libjpeg)
entropy-decodes baseline 4:2:0 JPEGs into raw Y/Cb/Cr planes — no chroma
upsample, no RGB conversion — so the host ships 1.5 B/px and the device does
the colour math (``tpuserve_torch.preproc.device_prepare_images_yuv420``).
ctypes releases the GIL for the call, so decode threads scale.

``load()`` builds the library on first use with ``cc -O2 -shared -fPIC ...
-ljpeg`` into ``build/native/libjpegyuv-<hash>.so`` at the root of the
checkout (``build/`` is git-ignored; the hash covers the source, so an edit
rebuilds), written under a temporary name and renamed into place. It returns
None when the compiler or libjpeg is missing; callers then take the PIL path
and count it in ``native_decode_fallback_total{model=}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from tpuserve_torch.utils.locks import new_lock

log = logging.getLogger("tpuserve_torch.native")

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "decode" / "jpegyuv.c"
BUILD_DIR = ROOT / "build" / "native"
CFLAGS = ("-O2", "-fPIC", "-shared")

_lock = new_lock("native.decoder")
_lib = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libjpegyuv-{digest[:12]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", str(tmp), str(SOURCE), "-ljpeg"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        log.warning("jpegyuv shim build failed (falling back to PIL): %s %s",
                    e, detail.decode(errors="replace")[-500:])
        tmp.unlink(missing_ok=True)
        return False


def load():
    """Return the loaded shim library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = library_path() if SOURCE.exists() else None
        if so is None or (not so.exists() and not _build(so)):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("jpegyuv shim load failed: %s", e)
            _load_failed = True
            return None
        lib.jpegyuv_decode.restype = ctypes.c_int
        lib.jpegyuv_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def decode_yuv420(payload: bytes, edge: int):
    """Decode an edge x edge 4:2:0 JPEG to (y, u, v) uint8 planes.

    Returns None when the shim is unavailable or the body is not an
    exact-size 4:2:0 baseline JPEG — the caller falls back to PIL.
    """
    lib = load()
    if lib is None:
        return None
    half = edge // 2
    y = np.empty((edge, edge), dtype=np.uint8)
    u = np.empty((half, half), dtype=np.uint8)
    v = np.empty((half, half), dtype=np.uint8)
    ptr = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.jpegyuv_decode(payload, len(payload), y.ctypes.data_as(ptr),
                            u.ctypes.data_as(ptr), v.ctypes.data_as(ptr), edge)
    if rc != 0:
        return None
    return y, u, v

"""ctypes binding for the native parallel npz writer.

The parity-dump path writes the reference-schema ``all_probs`` npz
([L, T, V] f32, GB-scale per prompt; reference ``src/run_generation.py:57``),
which numpy's ``savez_compressed`` deflates on one thread.
``native/npz_writer.cpp`` compresses each member in N parallel deflate
chunks (pigz-style ``Z_SYNC_FLUSH`` concatenation + ``crc32_combine``) and
writes a zip/npz that ``np.load`` reads unchanged.  The source and its chunk
plan are the JAX package's, so for the same arrays, zlib and thread count the
two packages write byte-equal files.  The pair cache, the lens summaries and
the delta artifacts all write through :func:`save_npz`.

The shared library builds at first use: one ``g++ -O3 -shared -fPIC
-pthread ... -lz`` into the gitignored ``csrc/build/``, under a name keyed by
the source's digest, written to a temporary name and renamed, so processes
that build at once never load a half-written library.  Unlike the JAX
package, nothing falls back to ``np.savez_compressed``: a failed build raises
with the compiler's output, a failed write with the writer's return code.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "native", "npz_writer.cpp")
BUILD_DIR = os.path.join(_PACKAGE, "csrc", "build")
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_library() -> str:
    """Compile the writer with ``COMPILER`` into ``BUILD_DIR`` unless a build
    of the same source and flags exists; returns the shared library's path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"npz_writer-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([COMPILER, *FLAGS, "-o", tmp, SOURCE, "-lz"],
                              capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"{COMPILER} could not run to build {SOURCE}: "
                           f"{exc}") from exc
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"{COMPILER} failed on {SOURCE} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.npz_open.restype = ctypes.c_void_p
            lib.npz_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.npz_add.restype = ctypes.c_int
            lib.npz_add.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64,
            ]
            lib.npz_close.restype = ctypes.c_int
            lib.npz_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the writer builds and loads here (``save_npz`` raises where
    it does not)."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def threads(n_threads: int = 0) -> int:
    """The deflate threads :func:`save_npz` uses: ``n_threads``, or every
    online core for 0 (as the writer's ``hardware_concurrency``)."""
    return n_threads if n_threads > 0 else max(1, os.cpu_count() or 1)


def _npy_header(arr: np.ndarray) -> bytes:
    """The .npy header bytes numpy would write for ``arr`` (v1.0 format)."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue()


def save_npz(
    path: str,
    arrays: Dict[str, np.ndarray],
    *,
    n_threads: int = 0,
    level: int = 6,
) -> bool:
    """Write a deflated npz at ``path`` (no suffix is added); returns True
    (the JAX package's signature, whose False meant its fallback ran).
    ``n_threads=0`` deflates on every core.  Raises ``OSError`` when the
    writer fails, and removes what it wrote."""
    lib = _library()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    handle = lib.npz_open(path.encode(), threads(n_threads), level)
    if not handle:
        raise OSError(f"npz_open({path}) failed")
    try:
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            header = _npy_header(arr)
            rc = lib.npz_add(
                handle, name.encode(),
                header, len(header),
                arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
            if rc != 0:
                raise OSError(f"npz_add({path}, {name}) failed: {rc}")
        rc = lib.npz_close(handle)
        handle = None
        if rc != 0:
            raise OSError(f"npz_close({path}) failed: {rc}")
    except BaseException:
        if handle is not None:
            lib.npz_close(handle)
        if os.path.exists(path):
            os.remove(path)
        raise
    return True

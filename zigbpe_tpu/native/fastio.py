"""ctypes binding for the native host runtime (fastio.cpp).

Builds lazily with g++ on first use; everything degrades gracefully to the
Python/NumPy paths when no compiler is available.

The library is compiled with ``-march=native``, so a library built on one
machine may hold instructions another machine's CPU lacks. Its file name
therefore carries a key of the source, the compiler flags and the target
the compiler resolves ``-march=native`` to on this host
(``libzigbpe-<key>.so`` next to the source): a library built elsewhere has
another key and is never loaded; this host builds its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "fastio.cpp"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

Merge = Tuple[int, int, int]


def build_key() -> str:
    """Hash of the source, the flags and this host's resolved target."""
    target = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True, timeout=60,
    ).stdout
    h = hashlib.sha256()
    for part in (_SRC.read_bytes(), " ".join(_FLAGS).encode(), target):
        h.update(part)
        h.update(b"\0")
    return h.hexdigest()[:16]


def lib_path(key: str) -> pathlib.Path:
    return _HERE / f"libzigbpe-{key}.so"


def build(force: bool = False) -> Optional[pathlib.Path]:
    """Compile fastio.cpp for this host unless a library with this host's
    key exists. Returns the library's path, or None without a compiler."""
    try:
        lib = lib_path(build_key())
        if lib.exists() and not force:
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)  # atomic: concurrent builders never see half
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.zbpe_read_file.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.zbpe_read_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.zbpe_free.argtypes = [ctypes.c_void_p]
        lib.zbpe_train.restype = ctypes.c_int64
        lib.zbpe_train.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.zbpe_encode.restype = ctypes.c_int64
        lib.zbpe_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.zbpe_byte_pair_hist.restype = None
        lib.zbpe_byte_pair_hist.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_file(path: str) -> bytes:
    lib = _load()
    if lib is None:
        return pathlib.Path(path).read_bytes()
    size = ctypes.c_int64()
    buf = lib.zbpe_read_file(os.fsencode(path), ctypes.byref(size))
    if not buf:
        raise OSError(f"failed to read {path}")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.zbpe_free(buf)


def train(data: bytes, vocab_size: int) -> List[Merge]:
    """Native single-core training; exact reference semantics."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if vocab_size < 256:
        raise ValueError(f"vocab_size must be >= 256, got {vocab_size}")
    m = vocab_size - 256
    out = (ctypes.c_int32 * (3 * max(m, 1)))()
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\0")
    k = lib.zbpe_train(buf, len(data), vocab_size, out)
    if k < 0:
        raise ValueError("invalid arguments to native train")
    return [(out[i * 3], out[i * 3 + 1], out[i * 3 + 2]) for i in range(k)]


def byte_pair_hist(data: bytes):
    """(256, 256) int32 histogram of adjacent byte pairs (overlaps
    included) — the host-side seed for the device trainer's upper-bound
    table. Returns None when the native library is unavailable."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    out = np.zeros((256 * 256,), dtype=np.int32)
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\0")
    lib.zbpe_byte_pair_hist(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    return out.reshape(256, 256)


def encode(data: bytes, merges: Sequence[Sequence[int]]) -> List[int]:
    """Native encode: replay merges in training order."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not data:
        return []
    flat = (ctypes.c_int32 * (3 * max(len(merges), 1)))()
    for i, (a, b, t) in enumerate(merges):
        flat[i * 3], flat[i * 3 + 1], flat[i * 3 + 2] = a, b, t
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = (ctypes.c_int32 * len(data))()
    n = lib.zbpe_encode(buf, len(data), flat, len(merges), out)
    return list(out[:n])

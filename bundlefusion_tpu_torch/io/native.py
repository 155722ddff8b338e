"""ctypes bindings for the native host codec (``native/sens_codec.cpp``).

Port of ``bundlefusion_tpu/io/native.py``: multithreaded zlib depth decode
for the .sens input path, the equivalent of the reference's C++ prefetch
threads (``RGBDFrameCacheRead``). This is host code, not a device kernel.

The committed ``native/libsenscodec.so`` is used as it is; nothing is built
into ``native/``. That library was compiled with ``-march=native``, so it is
first run once in a child process: if the child fails (the library does not
load, or this CPU lacks an instruction it uses), ``native/sens_codec.cpp`` is
compiled with the system C++ compiler into ``kernels/build/`` (git-ignored)
and that copy is used. With neither, and for any buffer the codec rejects,
depth decodes through Python's zlib.

Both paths convert a stored value ``v`` to metres as ``v * (1 / shift)`` in
float32, the codec's arithmetic, so they give the same bits (the
reference's Python path divides, ``v / shift``, which differs from the
codec's product by one ulp on more than half of all uint16 values).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import zlib
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO_ROOT, "native", "sens_codec.cpp")
_COMMITTED = os.path.join(_REPO_ROOT, "native", "libsenscodec.so")
_BUILT = os.path.join(_REPO_ROOT, "bundlefusion_tpu_torch", "kernels", "build",
                      "libsenscodec.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False
loaded_from: Optional[str] = None  # path of the library in use, None = Python zlib

_PROBE = """
import ctypes, sys, zlib
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
buf = zlib.compress(np.arange(64, dtype=np.uint16).tobytes())
out = np.empty(64, np.float32)
rc = lib.bf_decode_depth_batch((ctypes.c_char_p * 1)(buf), (ctypes.c_size_t * 1)(len(buf)),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               1, 64, ctypes.c_float(1000.0), 2)
sys.exit(0 if rc == 0 and abs(float(out[63]) - 0.063) < 1e-6 else 1)
"""


def _runs(path: str) -> bool:
    """Whether the library at ``path`` decodes a small buffer in a child
    process (a crash there cannot take this process down)."""
    if not os.path.exists(path):
        return False
    res = subprocess.run([sys.executable, "-c", _PROBE, path], capture_output=True,
                         timeout=60)
    return res.returncode == 0


def build_native(quiet: bool = True) -> bool:
    """Compile ``native/sens_codec.cpp`` into ``kernels/build/`` with the
    system C++ compiler. Returns True on success."""
    cxx = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if cxx is None or not os.path.exists(_SOURCE):
        return False
    os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
    tmp = f"{_BUILT}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", tmp,
                          _SOURCE, "-lz"], capture_output=quiet)
    if res.returncode != 0:
        return False
    os.replace(tmp, _BUILT)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, loaded_from
    if _tried:
        return _lib
    _tried = True
    path = _COMMITTED if _runs(_COMMITTED) else None
    if path is None and (_runs(_BUILT) or (build_native() and _runs(_BUILT))):
        path = _BUILT
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.bf_decode_depth_batch.restype = ctypes.c_int
    lib.bf_decode_depth_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_int,
    ]
    _lib, loaded_from = lib, path
    return lib


def native_available() -> bool:
    return _load() is not None


def decode_depth_batch_python(buffers: List[bytes], height: int, width: int,
                              depth_shift: float) -> np.ndarray:
    """The Python zlib path: [N, H, W] float32 metres (0 -> nan)."""
    inv_shift = np.float32(1.0) / np.float32(depth_shift)
    out = np.empty((len(buffers), height, width), np.float32)
    for i, buf in enumerate(buffers):
        raw = np.frombuffer(zlib.decompress(buf), np.uint16).reshape(height, width)
        out[i] = np.where(raw > 0, raw.astype(np.float32) * inv_shift, np.float32(np.nan))
    return out


def decode_depth_batch(
    buffers: List[bytes],
    height: int,
    width: int,
    depth_shift: float,
    num_threads: int = 4,
) -> np.ndarray:
    """Decode zlib uint16 depth buffers -> [N, H, W] float32 meters
    (0 -> nan). Uses the native multithreaded path when available; a batch
    the codec rejects decodes through Python zlib (a corrupt buffer then
    raises ``zlib.error``)."""
    n = len(buffers)
    n_px = height * width
    lib = _load()
    if lib is not None:
        out = np.empty((n, n_px), np.float32)
        src_arr = (ctypes.c_char_p * n)(*buffers)
        len_arr = (ctypes.c_size_t * n)(*[len(b) for b in buffers])
        rc = lib.bf_decode_depth_batch(
            src_arr,
            len_arr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            n_px,
            ctypes.c_float(depth_shift),
            num_threads,
        )
        if rc == 0:
            return out.reshape(n, height, width)
    return decode_depth_batch_python(buffers, height, width, depth_shift)

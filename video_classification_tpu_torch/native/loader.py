"""ctypes bindings and build of the native clip loader (vcloader.cc).

Port of the JAX package's ``native/loader.py``, with this package's own copy
of the C++ source. The shared library is built at first use with the JAX
package's flags (``g++ -O3 -march=native -shared -fPIC -std=c++17 ...
-ljpeg -lpthread``), by the C++ compiler ``utils/cuda.toolchain()`` picks,
into ``.torch_ext/native/`` at the root of the checkout (the JAX package
builds next to its source), under a name that carries a digest of the
source, the flags and the host's CPU model: a checkout copied to another
machine builds its own library instead of loading one made for another CPU
by ``-march=native``. The build needs a C++ compiler and libjpeg's
header and library (``jpeglib.h``, ``-ljpeg``); when either is missing,
``native_available()`` is False and ``build_error()`` says why.

The JAX package's library exports the same ``vcl_*`` symbols. ctypes loads
each library with ``RTLD_LOCAL``, so each package's functions resolve in its
own library when both are loaded in one process.

``NativeClipLoader`` keeps the JAX semantics: a 9-file 21-channel stack per
frame, pad-to-square and INTER_CUBIC resize, a missing frame filled with
127, the decode done by a C++ pthread worker pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..utils.cuda import BUILD_DIR, toolchain

NUM_FILES = 9
NUM_CHANNELS = 21

SRC = Path(__file__).resolve().parent / "vcloader.cc"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _so_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_cpu_model().encode())
    return BUILD_DIR / "native" / f"libvcloader-{digest.hexdigest()[:12]}.so"


SO_PATH = _so_path()
_build_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def compiler() -> str:
    """The C++ compiler of the build: ``toolchain()``'s ``CXX``, else g++."""
    return toolchain().get("CXX", "g++")


def jpeg_header_found(cxx: str) -> bool:
    """Whether ``cxx`` finds libjpeg's ``jpeglib.h`` (preprocesses an
    include of it)."""
    try:
        out = subprocess.run([cxx, "-E", "-x", "c++", "-"], capture_output=True, text=True,
                             input="#include <cstdio>\n#include <jpeglib.h>\n", timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0


def _build() -> Optional[str]:
    """Builds ``SO_PATH``; None, or why it could not be built."""
    try:
        cxx = compiler()
    except RuntimeError as e:
        return str(e)
    if shutil.which(cxx) is None:
        return f"no C++ compiler: {cxx!r} is not on the PATH"
    if not jpeg_header_found(cxx):
        return f"libjpeg's header jpeglib.h is not found by {cxx!r}"
    SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    # Built beside the target and renamed onto it: processes that build at
    # once (test workers, ranks) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=SO_PATH.parent)
    os.close(fd)
    cmd = [cxx, *FLAGS, str(SRC), "-o", tmp, "-ljpeg", "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            return f"{' '.join(cmd)} failed:\n{out.stderr}"
        os.replace(tmp, SO_PATH)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library (built if missing), or None if it cannot be
    built."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not SO_PATH.exists():
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(SO_PATH))  # RTLD_LOCAL
        lib.vcl_create.restype = ctypes.c_void_p
        lib.vcl_create.argtypes = [ctypes.c_int]
        lib.vcl_destroy.argtypes = [ctypes.c_void_p]
        lib.vcl_submit_clip.restype = ctypes.c_long
        lib.vcl_submit_clip.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.vcl_wait.restype = ctypes.c_int
        lib.vcl_wait.argtypes = [ctypes.c_void_p, ctypes.c_long]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (None if it was, or not tried)."""
    get_lib()
    return _build_error


class NativeClipLoader:
    """Submit/wait interface over the C++ worker pool.

    ``submit(paths, t, size)`` takes t*9 file paths (frame-major, order
    [rgb, U, V, F0..F4, D]; '' marks a missing frame) and returns a ticket;
    ``wait(ticket)`` blocks until the clip's (t, size, size, 21) uint8 stack
    is filled and returns it. Raises if the library cannot be built.
    """

    def __init__(self, num_threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._handle = lib.vcl_create(num_threads)
        self._outs = {}

    def close(self):
        if self._handle:
            self._lib.vcl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def submit(self, paths: Sequence[str], t: int, size: int):
        if len(paths) != t * NUM_FILES:
            raise ValueError(f"{len(paths)} paths for {t} frames of {NUM_FILES} files")
        out = np.empty((t, size, size, NUM_CHANNELS), np.uint8)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        ticket = self._lib.vcl_submit_clip(
            self._handle, arr, t, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        self._outs[ticket] = (out, arr)  # alive until wait()
        return ticket

    def wait(self, ticket) -> np.ndarray:
        status = self._lib.vcl_wait(self._handle, ticket)
        out, _ = self._outs.pop(ticket)
        if status != 0:
            raise RuntimeError("native clip load failed")
        return out

    def load_clip(self, paths: Sequence[str], t: int, size: int) -> np.ndarray:
        return self.wait(self.submit(paths, t, size))


def frame_paths_for(root: Path, crop_folder: str, nsetx3x5img: Path) -> List[str]:
    """The 9 modality file paths of one frame (the order of BuildFrame)."""
    frame = Path(root, crop_folder, nsetx3x5img)
    parent, name = frame.parent, frame.name
    if not frame.exists():
        return [""] * NUM_FILES
    return ([str(frame)]
            + [str(parent / f"{p}{name}") for p in ("U_", "V_")]
            + [str(parent / f"F{i}_{name}") for i in range(5)]
            + [str(parent / f"D_{name}")])

"""Device selection and the build of the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` behind plain C++ launchers, bound to
PyTorch by ``csrc/bindings.cpp``. ``build()`` compiles them as one extension
with ``torch.utils.cpp_extension.load`` at first use (ninja runs one compiler
per source, all at once) for ``sm_90a`` into ``.torch_ext/`` at the root of
the checkout; nothing is built when a module is imported.

The extension must link the shared C++ runtime (libstdc++.so) that torch
itself uses. A compiler whose library directory holds only the static
libstdc++.a links a private copy into the extension instead; a failed
``TORCH_CHECK`` whose message formats a number then builds the message in
that copy and hands it to torch's, and the process dies with SIGSEGV
instead of raising ``RuntimeError``. ``toolchain`` therefore keeps the
environment's ``CXX``/``CC`` only when that C++ compiler can link
libstdc++.so, and otherwise builds with the system's ``c++``/``cc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / ".torch_ext"
SOURCES = ("bindings.cpp", "flow_level.cu", "component_extents.cu", "nms.cu",
           "sor_solve.cu", "warp.cu", "label_components.cu")
# Headers the .cu files include (sor_solve.cu and flow_level.cu share the
# SOR tiles, component_extents.cu and label_components.cu the cluster
# strips). ``load`` hashes only the sources, so ``cuda_flags`` carries a
# digest of the headers: editing one changes the flags and rebuilds.
HEADERS = ("sor_tiles.cuh", "cluster_strips.cuh")
# -fmad=false keeps every multiply and add separately rounded (no fused
# multiply-add contraction), so a kernel performs the same float32 operations,
# in the same order, as its plain PyTorch twin.
CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false"]


def cuda_flags(csrc: Path = CSRC) -> list:
    """``CUDA_FLAGS`` plus the headers' digest, ``-DVCT_HEADERS=<sha1>``."""
    digest = hashlib.sha1()
    for h in HEADERS:
        digest.update((csrc / h).read_bytes())
    return CUDA_FLAGS + [f"-DVCT_HEADERS={digest.hexdigest()[:16]}"]


_ext = None
_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a usable card raises: entry
    points never drift to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def links_shared_libstdcxx(cxx: str) -> bool:
    """Whether ``-lstdc++`` links the shared libstdc++ with ``cxx``: the
    compiler finds libstdc++.so, and its libstdc++.a, if any, sits in the
    same directory (the linker takes the first directory holding either)."""
    found = {}
    for name in ("libstdc++.so", "libstdc++.a"):
        try:
            out = subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True,
                                 text=True, timeout=60, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return False
        found[name] = out if os.path.isabs(out) and os.path.exists(out) else None
    shared, static = found["libstdc++.so"], found["libstdc++.a"]
    return shared is not None and (static is None
                                   or os.path.dirname(static) == os.path.dirname(shared))


def toolchain(env=os.environ) -> Dict[str, str]:
    """The ``CXX`` and ``CC`` the build runs with: the environment's, if its
    C++ compiler links libstdc++.so, else the system ``c++`` and ``cc``.
    Raises if neither links the shared runtime."""
    cxx = env.get("CXX", "c++")
    if links_shared_libstdcxx(cxx):
        return {k: env[k] for k in ("CXX", "CC") if k in env}
    system = {"CXX": shutil.which("c++"), "CC": shutil.which("cc")}
    if system["CXX"] and system["CC"] and links_shared_libstdcxx(system["CXX"]):
        return system
    raise RuntimeError(
        f"the C++ compiler {cxx!r} finds no shared libstdc++ (only a static one), and "
        "neither does the system c++; an extension linked with a static libstdc++ "
        "crashes on its first failed input check")


def build():
    """The kernel extension (one function per ``.cu`` file of ``SOURCES``:
    ``flow_level``, ``component_extents``, ``nms``, ``sor_solve``,
    ``warp_bilinear``, ``label_components``; and ``component_extents_route``
    and ``label_components_route``), compiled at first use. Raises with the
    compiler's output if the build fails."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            chosen = toolchain()
            saved = {k: os.environ.get(k) for k in ("CXX", "CC")}
            os.environ.update(chosen)  # cpp_extension reads CXX and CC (nvcc -ccbin)
            try:
                _ext = load(name="vct_kernels",
                            sources=[str(CSRC / s) for s in SOURCES],
                            extra_cflags=["-O2"], extra_cuda_cflags=cuda_flags(),
                            build_directory=str(BUILD_DIR))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        return _ext

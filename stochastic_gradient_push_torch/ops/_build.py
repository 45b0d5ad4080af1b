"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes one or more plain C entry points and is
compiled by hand (no PyTorch headers, so a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -I csrc \
         -o build/sgp_torch_kernels/<name>-<hash>.so csrc/<name>.cu

into ``build/sgp_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), or for an installed package (no ``setup.py`` beside it)
into ``sgp_torch_kernels/`` under ``$XDG_CACHE_HOME`` or ``~/.cache``
(:func:`build_dir`), at first use, keyed by a hash of the source, the
``csrc/`` headers it includes with ``#include "..."`` (an edit to a
header rebuilds each library that includes it, and no other) and the
flags, with ``nvcc``'s output (``-Xptxas -v``'s registers, shared
memory and spills) kept beside it as ``<name>-<hash>.log``.  :func:`build`
starts one ``nvcc`` per source, all together.
Pointers and the stream cross as ``c_void_p`` (a bare int would be cut
to 32 bits); each entry point returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on anything but 0.  A build failure
raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KernelBuildError", "KernelLaunchError", "build", "build_dir",
           "check", "load", "nvcc_path", "stream", "KERNELS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(package: Path, env=os.environ) -> Path:
    """Where the libraries of the package at ``package`` are built: the
    git-ignored ``build/sgp_torch_kernels`` of the checkout that holds
    it (a directory with ``setup.py`` beside the package), else, for an
    installed package, the per-user cache ``$XDG_CACHE_HOME`` (or
    ``~/.cache``) ``/sgp_torch_kernels``."""
    root = package.parent
    if (root / "setup.py").is_file():
        return root / "build" / "sgp_torch_kernels"
    cache = env.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "sgp_torch_kernels"


BUILD_DIR = build_dir(CSRC.parent)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library (= source) name -> {C entry point: argtypes}; the stream is the
# last pointer
KERNELS = {
    "flash_fwd": {"sgp_flash_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
                  "sgp_flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _P)},
    "flash_bwd": {
        "sgp_flash_bwd_dq_f32": (_P,) * 7 + (_I, _I, _I, _P),
        "sgp_flash_bwd_dkv_f32": (_P,) * 8 + (_I, _I, _I, _P),
        "sgp_flash_bwd_dq_bf16": (_P,) * 7 + (_I, _I, _I, _P),
        "sgp_flash_bwd_dkv_bf16": (_P,) * 8 + (_I, _I, _I, _P),
    },
    "paged_decode": {"sgp_paged_decode_f32":
                     (_P,) * 7 + (_I,) * 7 + (_P,)},
    "gossip_edge": {
        "sgp_gossip_edge_start": (_P, _P, _L, _I, _P, _P, _L, _I, _P, _I, _I,
                                  _P),
        "sgp_gossip_edge_wait_f32": (_P, _P, _P, _L, _I, _I, _P),
        "sgp_gossip_edge_wait_bf16": (_P, _P, _P, _L, _I, _I, _P),
        "sgp_gossip_edge_wait_int8": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def nvcc_path() -> str:
    """The ``nvcc`` to build with; :class:`KernelBuildError` if none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels are built from csrc/ at first use on a machine "
        "with the CUDA toolkit")


def _local_headers(path: Path) -> list[Path]:
    """The ``csrc/`` headers that ``path`` includes as ``#include "..."``,
    directly or through another such header, in include order."""
    found, todo = [], [path]
    while todo:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              todo.pop().read_text(), re.M):
            header = CSRC / inc
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in _local_headers(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` per source, started together.  Returns
    ``{name: {"path", "seconds", "log"}}`` (``seconds`` 0 and the kept
    log for a library that was already there)."""
    names = list(KERNELS if names is None else names)
    out, procs = {}, {}
    nvcc = None
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists() and path.with_suffix(".log").exists():
            out[name] = {"path": str(path), "seconds": 0.0,
                         "log": path.with_suffix(".log").read_text()}
            continue
        nvcc = nvcc or nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{log}")
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)   # atomic: a concurrent build sees all or none
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``name`` with its entry points' argtypes
    set (builds it first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in KERNELS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream(x: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``x``'s device,
    the last argument of every entry point.  (``torch.cuda.
    current_stream`` would build a ``Stream`` object on every launch.)"""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero ``cudaError_t``."""
    if rc != 0:
        raise KernelLaunchError(
            f"{name} kernel launch failed: cudaError_t {rc}")

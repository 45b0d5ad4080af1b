"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes one or more plain C entry points and is
compiled by hand (no PyTorch headers, so a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/sgp_torch_kernels/<name>-<hash>.so

into ``build/sgp_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), at first use, keyed by a hash of the source and the
flags.  :func:`build` starts one ``nvcc`` per source, all together.
Pointers and the stream cross as ``c_void_p`` (a bare int would be cut
to 32 bits); each entry point returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on anything but 0.  A build failure
raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelBuildError", "KernelLaunchError", "build", "check",
           "load", "nvcc_path", "KERNELS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgp_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library (= source) name -> {C entry point: argtypes}; the stream is the
# last pointer
KERNELS = {
    "flash_fwd": {"sgp_flash_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P)},
    "flash_bwd": {
        "sgp_flash_bwd_dq_f32": (_P,) * 7 + (_I, _I, _I, _P),
        "sgp_flash_bwd_dkv_f32": (_P,) * 8 + (_I, _I, _I, _P),
    },
    "paged_decode": {"sgp_paged_decode_f32":
                     (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` per source, started together.  Returns
    ``{name: {"path", "seconds", "log"}}`` (``seconds`` 0 and an empty log
    for a library that was already there)."""
    names = list(KERNELS if names is None else names)
    out, procs = {}, {}
    nvcc = None
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{log}")
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


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero ``cudaError_t``."""
    if rc != 0:
        raise KernelLaunchError(
            f"{name} kernel launch failed: cudaError_t {rc}")

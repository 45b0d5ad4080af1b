"""The kernel build plumbing of ``stochastic_gradient_push_torch.ops._build``,
driven with a stand-in ``nvcc`` (a shell script), since the real one is
only on a machine with the CUDA toolkit: sources are built in parallel into
a hash-keyed library, a built library is not rebuilt and still reports
its ptxas log, an edit to a shared header ``csrc/*.cuh`` rebuilds the
libraries that include it and no other, a refused source or a missing compiler raises
``KernelBuildError``, and a non-zero CUDA error from a launch raises
``KernelLaunchError``.
"""

import os
import shutil
import stat

import pytest

from stochastic_gradient_push_torch.ops import _build


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    return d


# writes its -o target and logs its arguments
_OK = ('out=""; prev=""; for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
       'prev="$a"; done; echo "$@" >> "$(dirname "$out")/calls.log"; '
       'echo "ptxas info: Used 1 registers"; : > "$out"\n')


def test_builds_every_source_once_keyed_by_hash(tmp_path, monkeypatch,
                                                build_dir):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, _OK)))
    first = _build.build()
    assert set(first) == set(_build.KERNELS)
    for name, info in first.items():
        path = info["path"]
        assert os.path.exists(path) and path.startswith(str(build_dir))
        assert os.path.basename(path).startswith(name + "-")
        assert "registers" in info["log"]
    calls = (build_dir / "calls.log").read_text().splitlines()
    assert len(calls) == len(_build.KERNELS)
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c
               for c in calls)
    again = _build.build()
    assert all(info["seconds"] == 0.0 for info in again.values())
    # a cached library still reports ptxas's lines
    assert all("registers" in info["log"] for info in again.values())
    assert len((build_dir / "calls.log").read_text().splitlines()) == len(
        calls)


def test_refused_source_raises_build_error(tmp_path, monkeypatch,
                                           build_dir):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(
        tmp_path, 'echo "error: expected a ;"; exit 2\n')))
    with pytest.raises(_build.KernelBuildError, match="expected a ;"):
        _build.build(["flash_fwd"])
    assert not list(build_dir.glob("*.so"))


def test_missing_nvcc_raises_build_error(monkeypatch, build_dir):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(["paged_decode"])


def test_launch_error_code_raises():
    _build.check(0, "flash_fwd")
    with pytest.raises(_build.KernelLaunchError, match="cudaError_t 9"):
        _build.check(9, "flash_fwd")


def test_header_edit_rebuilds_the_libraries(tmp_path, monkeypatch,
                                            build_dir):
    # a .cu that includes a shared .cuh builds once; after the header's
    # bytes change the library's path changes and nvcc runs again, with
    # -I for the sources' directory
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, _OK)))
    assert '#include "tf32_mma.cuh"' in (csrc / "flash_bwd.cu").read_text()
    first = _build.build(["flash_bwd"])["flash_bwd"]
    again = _build.build(["flash_bwd"])["flash_bwd"]
    assert again["seconds"] == 0.0 and again["path"] == first["path"]
    calls = (build_dir / "calls.log").read_text().splitlines()
    assert len(calls) == 1 and f"-I {csrc} " in calls[0]
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    third = _build.build(["flash_bwd"])["flash_bwd"]
    assert third["path"] != first["path"] and os.path.exists(third["path"])
    assert len((build_dir / "calls.log").read_text().splitlines()) == 2


def test_header_edit_leaves_other_libraries_alone(tmp_path, monkeypatch):
    # only the headers a source names in `#include "..."` (and theirs)
    # key its library: a source that includes none keeps its path
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    (csrc / "inner.cuh").write_text("// inner\n")
    header = csrc / "tf32_mma.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert _build._local_headers(csrc / "flash_fwd.cu") == [
        header, csrc / "inner.cuh"]
    assert _build._local_headers(csrc / "paged_decode.cu") == []
    before = {n: _build._lib_path(n) for n in ("flash_fwd", "paged_decode")}
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert _build._lib_path("flash_fwd") != before["flash_fwd"]
    assert _build._lib_path("paged_decode") == before["paged_decode"]


def test_flash_sources_share_the_header_and_keep_no_copy():
    header = (_build.CSRC / "tf32_mma.cuh").read_text()
    helpers = ("uint32_t tf32(", "void split(", "void mma(", "void mma3(",
               "void mma3z(", "cp.async.commit_group",
               "cudaFuncSetAttribute")
    assert all(h in header for h in helpers)
    for name in ("flash_fwd", "flash_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "tf32_mma.cuh"' in src
        assert not [h for h in helpers if h in src], name

"""The kernel build plumbing of ``stochastic_gradient_push_torch.ops._build``,
driven with a stand-in ``nvcc`` (a shell script), since the real one is
only on a machine with the CUDA toolkit: sources are built in parallel into
a hash-keyed library, a built library is not rebuilt and still reports
its ptxas log, a refused source or a missing compiler raises
``KernelBuildError``, and a non-zero CUDA error from a launch raises
``KernelLaunchError``.
"""

import os
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

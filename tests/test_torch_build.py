"""The kernel build plumbing of ``stochastic_gradient_push_torch.ops._build``,
driven with a stand-in ``nvcc`` (a shell script), since the real one is
only on a machine with the CUDA toolkit: sources are built in parallel into
a hash-keyed library, a built library is not rebuilt and still reports
its ptxas log, an edit to a shared header ``csrc/*.cuh`` (the TF32
``mma.sync`` helpers, the bf16 packing helpers, the Hopper ``wgmma``/TMA
helpers) rebuilds the libraries that include it and no other, the bf16
kernels keep none of the warp-level product helpers they ran on before
``wgmma``, a refused source or a
missing compiler raises ``KernelBuildError``, and a non-zero CUDA error
from a launch raises ``KernelLaunchError``.
"""

import os
import re
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
        csrc / "bf16_mma.cuh", csrc / "sm90_bf16.cuh", header,
        csrc / "inner.cuh"]
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


def test_flash_sources_share_the_bf16_header_and_keep_no_copy():
    # the bf16 forms of K3-K5 take their packing, hi/lo split and rounded
    # store from csrc/bf16_mma.cuh; an edit there rebuilds both flash
    # libraries and no other
    header = (_build.CSRC / "bf16_mma.cuh").read_text()
    helpers = ("uint32_t pack(", "float lo_f(", "float hi_f(", "void split(",
               "void store_rows(")
    assert all(h in header for h in helpers)
    for name in ("flash_fwd", "flash_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "bf16_mma.cuh"' in src
        assert not [h for h in helpers if h in src], name
        assert _build.CSRC / "bf16_mma.cuh" in _build._local_headers(
            _build.CSRC / f"{name}.cu")
    for name in ("paged_decode", "gossip_edge"):
        assert _build.CSRC / "bf16_mma.cuh" not in _build._local_headers(
            _build.CSRC / f"{name}.cu")


def _bf16_namespace(name: str) -> str:
    """The text of ``csrc/<name>.cu``'s bf16 kernels (``namespace bf16k``)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    start = src.index("namespace bf16k {")
    return src[start:src.index("}  // namespace bf16k", start)]


# the warp-level bf16 product helpers the kernels ran on before wgmma
_RETIRED_BF16 = ("mma(", "mmaz(", "ldsm_x4(", "ldsm_x4_t(", "cp_async16(",
                 "cp_async_commit(", "cp_async_wait<", "load_rows(",
                 "load_a(", "rows_by_tile(", "acc_by_tile(")


def test_bf16_header_keeps_no_warp_level_product_helper():
    # bf16_mma.cuh holds exactly the helpers the wgmma kernels use: no
    # mma.sync, ldmatrix or cp.async helper, no staged-tile stride; and
    # the bf16 namespaces of both flash sources call none of the retired
    # helpers, with dQ, dK/dV and the forward all on wgmma fed by TMA
    header = (_build.CSRC / "bf16_mma.cuh").read_text()
    code = re.sub(r"//[^\n]*", "", header)
    for ptx in ("mma.sync", "ldmatrix", "cp.async"):
        assert ptx not in code, ptx
    defined = re.findall(r"__device__ __forceinline__ \w+ (\w+)\(", code)
    assert sorted(defined) == ["hi_f", "lo_f", "pack", "split", "store_rows"]
    assert re.findall(r"constexpr int (\w+)", code) == ["D"]
    kernels = {"flash_fwd": ("flash_fwd_bf16_kernel",),
               "flash_bwd": ("flash_bwd_dq_bf16_kernel",
                             "flash_bwd_dkv_bf16_kernel")}
    for name, entries in kernels.items():
        body = re.sub(r"//[^\n]*", "", _bf16_namespace(name))
        for ptx in ("mma.sync", "ldmatrix"):
            assert ptx not in body, (name, ptx)
        called = [h for h in _RETIRED_BF16
                  if re.search(r"(?<![\w.])" + re.escape(h), body)]
        assert not called, (name, called)
        assert all(e in body for e in entries), name
        assert body.count("wgmma_rs(") >= 2 * len(entries), name
        assert body.count("tma_load_3d(") >= 2 * len(entries), name


def test_flash_sources_share_the_sm90_header_and_keep_no_copy(tmp_path,
                                                              monkeypatch):
    # the bf16 forward, dQ and dK/dV take their wgmma, TMA and mbarrier
    # helpers from csrc/sm90_bf16.cuh: an edit there rebuilds both flash
    # libraries and no other, and the bf16 forward keeps none of the
    # mma.sync helpers it ran on before
    header = (_build.CSRC / "sm90_bf16.cuh").read_text()
    helpers = ("void mbar_wait(", "void tma_load_3d(", "uint64_t desc_sw128(",
               "void wgmma_ss(", "void wgmma_rs(", "void split_acc(",
               "int rows_map(", "wgmma.mma_async.sync.aligned.m64n64k16",
               "cp.async.bulk.tensor.3d", "cuTensorMapEncodeTiled")
    assert all(h in header for h in helpers)
    for name in ("flash_fwd", "flash_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90_bf16.cuh"' in src
        assert not [h for h in helpers if h in src], name
    fwd = (_build.CSRC / "flash_fwd.cu").read_text()
    assert not [h for h in ("rows_by_tile(", "acc_by_tile(", "load_a(",
                            "load_rows(") if h in fwd]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("flash_fwd", "flash_bwd", "paged_decode", "gossip_edge")
    before = {n: _build._lib_path(n) for n in names}
    (csrc / "sm90_bf16.cuh").write_text(header + "// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == [
        "flash_fwd", "flash_bwd"]

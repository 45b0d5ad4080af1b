"""The port's kernel sources ship with the package, and an installed
package builds its kernels outside ``site-packages``.

* Every file under ``stochastic_gradient_push_torch/csrc/``, and every
  ``#include "..."`` in one, matches a ``package_data`` glob of
  ``setup.py``; ``setup.py build_py`` into a scratch directory ships
  each source with every header it includes.
* ``ops/_build.py::build_dir``: ``build/sgp_torch_kernels`` at the root of
  a checkout (a directory with ``setup.py`` beside the package), else
  ``sgp_torch_kernels`` under ``$XDG_CACHE_HOME`` or ``~/.cache``; the
  built copy imported on its own resolves there.
"""

import ast
import fnmatch
import json
import os
import pathlib
import re
import subprocess
import sys

from stochastic_gradient_push_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "stochastic_gradient_push_torch"
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _package_data_globs() -> list[str]:
    tree = ast.parse((REPO / "setup.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            data = ast.literal_eval(node.value)
            return data[PKG]
    raise AssertionError("setup.py has no package_data")


def _sources(csrc: pathlib.Path):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))


def test_every_source_and_local_include_matches_package_data():
    globs = _package_data_globs()
    csrc = REPO / PKG / "csrc"
    includes = set()
    for src in _sources(csrc):
        rel = f"csrc/{src.name}"
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
        includes.update(INCLUDE.findall(src.read_text()))
    assert "tf32_mma.cuh" in includes
    for inc in sorted(includes):
        assert (csrc / inc).is_file(), inc
        assert any(fnmatch.fnmatch(f"csrc/{inc}", g) for g in globs), inc


def test_build_py_ships_every_header_a_source_includes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "setup.py", "-q", "build_py", "--build-lib",
         str(tmp_path / "lib")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    shipped = tmp_path / "lib" / PKG / "csrc"
    names = {p.name for p in _sources(shipped)}
    assert names == {p.name for p in _sources(REPO / PKG / "csrc")}
    for src in _sources(shipped):
        for inc in INCLUDE.findall(src.read_text()):
            assert (shipped / inc).is_file(), (src.name, inc)


def test_build_dir_in_a_checkout_and_in_an_installed_package(tmp_path,
                                                              monkeypatch):
    assert _build.build_dir(REPO / PKG) == REPO / "build" / "sgp_torch_kernels"
    assert _build.BUILD_DIR == _build.build_dir(_build.CSRC.parent)
    site = tmp_path / "site-packages" / PKG
    site.mkdir(parents=True)
    cache = tmp_path / "cache"
    assert _build.build_dir(site, {"XDG_CACHE_HOME": str(cache)}) == \
        cache / "sgp_torch_kernels"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(site, {}) == \
        tmp_path / "home" / ".cache" / "sgp_torch_kernels"


def test_installed_copy_builds_under_the_user_cache(tmp_path):
    lib = tmp_path / "lib"
    subprocess.run([sys.executable, "setup.py", "-q", "build_py",
                    "--build-lib", str(lib)], cwd=REPO, check=True,
                   capture_output=True, timeout=120)
    probe = ("import json; from stochastic_gradient_push_torch.ops import "
             "_build as b; print(json.dumps([str(b.BUILD_DIR), "
             "str(b.CSRC)]))")
    env = dict(os.environ, PYTHONPATH=str(lib),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    build_dir, csrc = json.loads(out.strip().splitlines()[-1])
    assert build_dir == str(tmp_path / "cache" / "sgp_torch_kernels")
    assert csrc == str(lib / PKG / "csrc")

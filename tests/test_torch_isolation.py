"""The port stands alone: ``stochastic_gradient_push_torch`` (its
numpy-only ``planner/`` and ``analysis/`` included), ``chip_smoke.py``
and the port's chip scripts (``scripts/torch_*.py``) import neither jax
nor the JAX package.

One check runs the imports in a fresh interpreter where ``import jax``
fails; the other reads the sources with ``ast``.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "stochastic_gradient_push_torch"
SMOKE = REPO / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stochastic_gradient_push_tpu")


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return (sorted(PORT.rglob("*.py")) + [SMOKE]
            + sorted((REPO / "scripts").glob("torch_*.py")))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_never_imports_jax_or_the_reference(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.name} imports {sorted(bad)}"


_PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
import stochastic_gradient_push_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".")]
names += ["chip_smoke"] + json.loads(sys.argv[2])
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(
    m for m in sys.modules if m.startswith("stochastic_gradient_push"))}))
"""


def test_every_module_imports_with_jax_unavailable():
    smoke_mods = sorted(m for m in _imported_modules(SMOKE)
                        if m.startswith("stochastic_gradient_push_torch"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO), json.dumps(smoke_mods)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"stochastic_gradient_push_torch.serve.engine",
                "stochastic_gradient_push_torch.serve.cli",
                "stochastic_gradient_push_torch.ops._build",
                "stochastic_gradient_push_torch.ops.gossip_kernel",
                "stochastic_gradient_push_torch.train.lm",
                "stochastic_gradient_push_torch.run.gossip_lm",
                "stochastic_gradient_push_torch.parallel.collectives",
                "stochastic_gradient_push_torch.parallel.discovery",
                "stochastic_gradient_push_torch.parallel.multihost",
                "stochastic_gradient_push_torch.parallel.seq",
                "stochastic_gradient_push_torch.parallel.ring_attention",
                "stochastic_gradient_push_torch.ops.ring_flash",
                "stochastic_gradient_push_torch.algorithms.algorithms",
                "stochastic_gradient_push_torch.topology.graphs",
                "stochastic_gradient_push_torch.data.lm",
                "stochastic_gradient_push_torch.data.synthetic",
                "stochastic_gradient_push_torch.models.resnet",
                "stochastic_gradient_push_torch.models.small",
                "stochastic_gradient_push_torch.train.step",
                "stochastic_gradient_push_torch.run.dryrun",
                "stochastic_gradient_push_torch.run.gossip_sgd",
                "stochastic_gradient_push_torch.run.gossip_sgd_adpsgd",
                "stochastic_gradient_push_torch.train.loop",
                "stochastic_gradient_push_torch.train.lr",
                "stochastic_gradient_push_torch.utils.checkpoint",
                "stochastic_gradient_push_torch.utils.logging",
                "stochastic_gradient_push_torch.utils.meter",
                "stochastic_gradient_push_torch.data.pipeline",
                "stochastic_gradient_push_torch.data.imagefolder",
                "stochastic_gradient_push_torch.data.streaming",
                "stochastic_gradient_push_torch.data.prefetch",
                "stochastic_gradient_push_torch.train.async_bilat",
                "stochastic_gradient_push_torch.utils.profiling",
                "stochastic_gradient_push_torch.topology.schedule",
                "stochastic_gradient_push_torch.resilience.faults",
                "stochastic_gradient_push_torch.resilience.monitor",
                "stochastic_gradient_push_torch.resilience.recovery",
                "stochastic_gradient_push_torch.topology.hierarchical",
                "stochastic_gradient_push_torch.topology.synthesized",
                "stochastic_gradient_push_torch.analysis.findings",
                "stochastic_gradient_push_torch.analysis.verifier",
                "stochastic_gradient_push_torch.planner.alpha",
                "stochastic_gradient_push_torch.planner.interconnect",
                "stochastic_gradient_push_torch.planner.policy",
                "stochastic_gradient_push_torch.planner.scorer",
                "stochastic_gradient_push_torch.planner.synthesize",
                "chip_smoke"}
    assert expected <= set(result["imported"])
    assert not [m for m in result["loaded"]
                if m.startswith("stochastic_gradient_push_tpu")]

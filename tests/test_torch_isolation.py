"""The port stands alone: ``stochastic_gradient_push_torch`` (its
numpy-only ``planner/`` and ``analysis/`` included), ``chip_smoke.py``
and the port's chip scripts (``scripts/torch_*.py``) import neither jax
nor the JAX package.

One check runs the imports in a fresh interpreter where ``import jax``
(and ``orbax``) fails; another reads the sources with ``ast``; a third
runs the LM command line's harness (whose imports sit inside ``main``),
its resume, a resume at another world, the consensus ingest and the
DCP backend in such an interpreter.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "stochastic_gradient_push_tpu")


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
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
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
                "stochastic_gradient_push_torch.serve.bench",
                "stochastic_gradient_push_torch.serve.paged_attention",
                "stochastic_gradient_push_torch.parallel.tp",
                "stochastic_gradient_push_torch.ops._build",
                "stochastic_gradient_push_torch.ops.gossip_kernel",
                "stochastic_gradient_push_torch.train.lm",
                "stochastic_gradient_push_torch.run.gossip_lm",
                "stochastic_gradient_push_torch.parallel.collectives",
                "stochastic_gradient_push_torch.parallel.discovery",
                "stochastic_gradient_push_torch.parallel.multihost",
                "stochastic_gradient_push_torch.parallel.seq",
                "stochastic_gradient_push_torch.parallel.mesh",
                "stochastic_gradient_push_torch.parallel.averaging",
                "stochastic_gradient_push_torch.utils.flatten",
                "stochastic_gradient_push_torch.parallel.ring_attention",
                "stochastic_gradient_push_torch.ops.ring_flash",
                "stochastic_gradient_push_torch.algorithms.algorithms",
                "stochastic_gradient_push_torch.topology.graphs",
                "stochastic_gradient_push_torch.data.lm",
                "stochastic_gradient_push_torch.data.synthetic",
                "stochastic_gradient_push_torch.models.resnet",
                "stochastic_gradient_push_torch.models.convert",
                "stochastic_gradient_push_torch.models.small",
                "stochastic_gradient_push_torch.train.step",
                "stochastic_gradient_push_torch.run.dryrun",
                "stochastic_gradient_push_torch.run.gossip_sgd",
                "stochastic_gradient_push_torch.run.gossip_sgd_adpsgd",
                "stochastic_gradient_push_torch.train.loop",
                "stochastic_gradient_push_torch.train.lr",
                "stochastic_gradient_push_torch.utils.checkpoint",
                "stochastic_gradient_push_torch.utils.dcp_ckpt",
                "stochastic_gradient_push_torch.supervise",
                "stochastic_gradient_push_torch.supervise.reshard",
                "stochastic_gradient_push_torch.serve.load",
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
                "stochastic_gradient_push_torch.telemetry",
                "stochastic_gradient_push_torch.telemetry.comm",
                "stochastic_gradient_push_torch.telemetry.metrics",
                "stochastic_gradient_push_torch.telemetry.registry",
                "stochastic_gradient_push_torch.telemetry.sink",
                "stochastic_gradient_push_torch.telemetry.tracer",
                "stochastic_gradient_push_torch.parallel.wirecheck",
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


_HARNESS_RUN = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.run import gossip_lm
d = sys.argv[2]
with open(d + "/corpus.txt", "wb") as f:
    f.write(bytes(range(256)) * 40)
argv = ["--device", "cpu", "--vocab_size", "256", "--d_model", "16",
        "--n_layers", "1", "--n_heads", "1", "--d_ff", "32", "--seq_len",
        "16", "--batch_size", "2", "--world_size", "2", "--print_freq", "1",
        "--corpus_file", d + "/corpus.txt", "--val_frac", "0.1",
        "--checkpoint_dir", d, "--profile_dir", d + "/prof",
        "--profile_start_step", "1", "--profile_steps", "1"]
gossip_lm.main(argv + ["--num_steps", "1", "--ckpt_every", "1"])
result = gossip_lm.main(argv + ["--num_steps", "2", "--resume", "True"])
# the consensus for serving, a resume at world 1 (the reshard), and the
# DCP backend
from stochastic_gradient_push_torch.serve.load import load_consensus
load_consensus(d, tag="lm_")
gossip_lm.main(argv + ["--num_steps", "3", "--resume", "True",
                       "--world_size", "1"])
gossip_lm.main(argv + ["--num_steps", "1", "--ckpt_backend", "orbax",
                       "--checkpoint_dir", d + "/dcp"])
print(json.dumps({"result": result, "loaded": sorted(
    m for m in sys.modules if m.startswith("stochastic_gradient_push"))}))
"""


def test_lm_harness_runs_with_jax_unavailable(tmp_path):
    """The LM CLI's harness imports inside ``main`` (file corpus,
    validation, checkpoints, resume, the profile window): a run and its
    resume in an interpreter where ``import jax`` fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _HARNESS_RUN, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "val_loss" in out["result"] and "resumed from step 1" \
        in proc.stdout
    assert not [m for m in out["loaded"]
                if m.startswith("stochastic_gradient_push_tpu")]


_TELEMETRY_RUN = r"""
import json, os, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.parallel import wirecheck
from stochastic_gradient_push_torch.run import gossip_lm
d = sys.argv[2]
assert wirecheck.selftest("cpu") == 0
gossip_lm.main(["--device", "cpu", "--vocab_size", "64", "--d_model", "16",
                "--n_layers", "1", "--n_heads", "1", "--d_ff", "32",
                "--seq_len", "16", "--batch_size", "2", "--world_size", "2",
                "--print_freq", "1", "--num_steps", "2", "--corpus_tokens",
                "2000", "--checkpoint_dir", d, "--trace_dir", d + "/tel",
                "--metrics_every", "1"])
print(json.dumps({"files": sorted(os.listdir(d + "/tel")), "loaded": sorted(
    m for m in sys.modules if m.startswith("stochastic_gradient_push"))}))
"""


def test_telemetry_and_the_wire_selftest_run_with_jax_unavailable(tmp_path):
    """``scripts/torch_wirecheck.py``'s selftest and a traced LM run in
    an interpreter where ``import jax`` fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _TELEMETRY_RUN, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "wire selftest: OK" in proc.stdout
    assert out["files"] == ["events.jsonl", "trace.json"]
    assert "stochastic_gradient_push_torch.telemetry.comm" in out["loaded"]
    assert not [m for m in out["loaded"]
                if m.startswith("stochastic_gradient_push_tpu")]


_SERVE_RUN = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.serve import cli
assert cli.main(["--selftest", "--device", "cpu"]) == 0
print(json.dumps({"loaded": sorted(
    m for m in sys.modules if m.startswith("stochastic_gradient_push"))}))
"""


def test_serve_selftest_runs_with_jax_unavailable():
    """The serve CLI's selftest (training at world 4, the ingest, the
    2-shard engine and 50 requests; its imports sit inside the function)
    in an interpreter where ``import jax`` fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SERVE_RUN, str(REPO)],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "serve selftest: OK" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"stochastic_gradient_push_torch.serve.load",
            "stochastic_gradient_push_torch.parallel.tp",
            "stochastic_gradient_push_torch.run.gossip_lm"} <= set(
                out["loaded"])
    assert not [m for m in out["loaded"]
                if m.startswith("stochastic_gradient_push_tpu")]


_SLICE_RUN = r"""
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.run import gossip_lm, gossip_sgd
d = sys.argv[2]
# the image CLI's chunked loop and the space-to-depth stem
gossip_sgd.main(["--device", "cpu", "--dataset", "synthetic", "--model",
                 "resnet18", "--image_size", "16", "--num_classes", "4",
                 "--batch_size", "2", "--world_size", "2", "--num_epochs",
                 "1", "--num_iterations_per_training_epoch", "3",
                 "--num_itr_ignore", "1", "--scan_steps", "2",
                 "--stem_s2d", "True", "--checkpoint_dir", d + "/img"])
# the ProbeBatchNorm variants
from stochastic_gradient_push_torch.models import resnet
from stochastic_gradient_push_torch.models.convert import init_model_params
for variant in ("bn16", "folded"):
    m = resnet.resnet18(num_classes=4, norm_variant=variant)
    p, s = init_model_params(m, 0)
    m.load_state_dict({**p, **s})
    assert torch.isfinite(m(torch.zeros(2, 3, 16, 16), True, {})).all()
# --tp on a head count it does not divide
gossip_lm.main(["--device", "cpu", "--world_size", "4", "--tp", "2",
                "--n_heads", "3", "--d_model", "24", "--d_ff", "32",
                "--vocab_size", "64", "--n_layers", "1", "--seq_len", "16",
                "--batch_size", "2", "--num_steps", "2", "--corpus_tokens",
                "2000", "--checkpoint_dir", d + "/lm"])
print(json.dumps({"loaded": sorted(
    m for m in sys.modules if m.startswith("stochastic_gradient_push"))}))
"""


def test_scan_steps_the_resnet_variants_and_tp_heads_run_with_jax_unavailable(
        tmp_path):
    """``--scan_steps`` with ``--stem_s2d`` through the image CLI, the
    ``bn16`` and ``folded`` norms, and ``--tp 2`` over 3 heads through
    the LM CLI, in an interpreter where ``import jax`` fails."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE_RUN, str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"stochastic_gradient_push_torch.models.resnet",
            "stochastic_gradient_push_torch.models.convert",
            "stochastic_gradient_push_torch.parallel.tp",
            "stochastic_gradient_push_torch.train.loop"} <= set(out["loaded"])
    assert not [m for m in out["loaded"]
                if m.startswith("stochastic_gradient_push_tpu")]

"""Port parity: the planner's flags in both training CLIs.

* ``--topology``, ``--synth_*``, ``--gap_floor``, ``--slice_size``,
  ``--dcn_cost``, ``--ici_cost``, ``--mixing_alpha`` and ``--graph_type
  6`` parse, act, and are gone from both ``UNPORTED`` tables.
* ``_resolve_plan`` against the reference's on the same command lines:
  the same plan (``cfg.plan``, the graph's name, the averaging period,
  the mixing), the same ``SystemExit`` texts (all_reduce, bilateral,
  world 1, stray synth knobs, bad alphas).
* The ``gossip plan:`` line the port's CLI prints equals the
  reference's ``plan.to_dict()``.
* A tiny run at world 4 (``tiny_cnn``, 16 px) with ``--topology
  hierarchical --slice_size 2`` and with ``--topology synth``: every
  ``gossip health:`` line has ``ps_mass_err`` 0.0; the rank files' meta
  carries the plan; ``--resume True`` re-plans onto the stamped
  fingerprint.
* The LM CLI plans at world 4 with the same line as the reference's
  planner, and ``--graph_type 6`` trains.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.run import gossip_lm, gossip_sgd

torch.set_num_threads(1)

BASE = ["--dataset", "synthetic", "--model", "tiny_cnn", "--image_size",
        "16", "--num_classes", "10", "--batch_size", "4", "--num_epochs",
        "1", "--num_iterations_per_training_epoch", "2", "--num_itr_ignore",
        "1", "--print_freq", "1", "--verbose", "False"]
PLANNER_FLAGS = ("--topology", "--synth_seed", "--synth_budget",
                 "--synth_beam", "--synth_phases", "--gap_floor",
                 "--slice_size", "--dcn_cost", "--ici_cost",
                 "--mixing_alpha")


@pytest.mark.parametrize("module", [gossip_sgd, gossip_lm],
                         ids=["gossip_sgd", "gossip_lm"])
def test_planner_flags_left_the_unported_tables(module):
    assert not set(PLANNER_FLAGS) & set(module.UNPORTED)
    actions = {a.option_strings[0]: a for a in module.build_parser()._actions
               if a.option_strings}
    for flag in PLANNER_FLAGS:
        assert actions[flag].help != "==SUPPRESS==", flag
    assert 6 in actions["--graph_type"].choices


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(fmt % args if args else fmt)

    def warning(self, msg, *args):
        self.lines.append(msg % args if args else msg)


def _both(argv, world, adpsgd=False):
    """The reference's and the port's ``(cfg, log)`` after
    ``_resolve_plan``, or their ``SystemExit`` texts."""
    from stochastic_gradient_push_tpu.run import gossip_sgd as rsgd

    out = []
    for mod, extra in ((rsgd, []), (gossip_sgd, ["--device", "cpu"])):
        log = _Log()
        try:
            cfg, args = mod.parse_config(BASE + extra + argv)
            if adpsgd:
                cfg.bilat = True
            mod._resolve_plan(cfg, args, world, log)
        except SystemExit as e:
            out.append(("exit", str(e)))
            continue
        out.append((cfg, log))
    return out


PLAN_ARGVS = [
    [],
    ["--graph_type", "4"],
    ["--graph_type", "6"],
    ["--graph_type", "6", "--slice_size", "2"],
    ["--topology", "auto"],
    ["--topology", "auto", "--slice_size", "2", "--dcn_cost", "16"],
    ["--topology", "auto", "--slice_size", "4", "--ici_cost", "2"],
    ["--topology", "synth", "--slice_size", "2", "--dcn_cost", "16"],
    ["--topology", "synth", "--slice_size", "4", "--synth_budget", "200",
     "--synth_phases", "3", "--synth_seed", "3", "--synth_beam", "4"],
    ["--topology", "ring", "--gap_floor", "0.5"],
    ["--topology", "ring", "--gap_floor", "0.5", "--global_avg_every", "0"],
    ["--topology", "exponential", "--global_avg_every", "3"],
    ["--mixing_alpha", "auto"],
    ["--mixing_alpha", "0.7", "--topology", "auto"],
    ["--topology", "auto", "--wire_dtype", "int8", "--error_feedback",
     "True"],
    ["--topology", "auto", "--inject_faults", "drop:0->1@0:2",
     "--slice_size", "2"],
    ["--topology", "auto", "--overlap", "True", "--staleness", "2"],
    ["--push_sum", "False", "--topology", "auto"],
    ["--peers_per_itr_schedule", "0", "2", "--topology", "auto"],
]


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", range(len(PLAN_ARGVS)))
def test_resolve_plan_equals_reference(case, world):
    from stochastic_gradient_push_tpu.topology import topology_name

    argv = PLAN_ARGVS[case] + ["--world_size", str(world)]
    (rcfg, rlog), (tcfg, tlog) = _both(argv, world)
    assert json.dumps(tcfg.plan, sort_keys=True) == \
        json.dumps(rcfg.plan, sort_keys=True)
    assert tlog.lines == rlog.lines
    assert tlog.lines[0].startswith("gossip plan: ")
    assert topology_name(rcfg.graph_class) == \
        gossip_sgd_topology_name(tcfg.graph_class)
    assert tcfg.global_avg_every == rcfg.global_avg_every
    rmix = rcfg.mixing_class() if rcfg.mixing_class else None
    tmix = tcfg.mixing_class() if tcfg.mixing_class else None
    assert type(tmix).__name__ == type(rmix).__name__
    if hasattr(rmix, "alpha"):
        np.testing.assert_array_equal(tmix.alpha, rmix.alpha)


def gossip_sgd_topology_name(cls):
    from stochastic_gradient_push_torch.topology import topology_name

    return topology_name(cls)


EXIT_ARGVS = [
    (["--all_reduce", "True", "--graph_type", "-1", "--topology", "auto"],
     4, False),
    (["--all_reduce", "True", "--graph_type", "-1", "--slice_size", "2"],
     4, False),
    (["--slice_size", "2"], 4, True),
    (["--topology", "auto"], 4, True),
    (["--topology", "synth"], 1, False),
    (["--mixing_alpha", "0.5"], 1, False),
    (["--dcn_cost", "8"], 1, False),
    (["--synth_budget", "10"], 4, False),
    (["--topology", "auto", "--synth_seed", "1"], 4, False),
    (["--mixing_alpha", "1.5"], 4, False),
    (["--mixing_alpha", "lots"], 4, False),
    (["--mixing_alpha", "0.5", "--push_sum", "False"], 4, False),
    (["--graph_type", "-1"], 4, False),
]


@pytest.mark.parametrize("case", range(len(EXIT_ARGVS)))
def test_refusals_equal_reference(case):
    argv, world, adpsgd = EXIT_ARGVS[case]
    ref, port = _both(argv + ["--world_size", str(world)], world, adpsgd)
    assert ref[0] == "exit" and port == ref


def test_single_rank_and_bilateral_runs_plan_nothing():
    (rcfg, rlog), (tcfg, tlog) = _both(["--world_size", "1"], 1)
    assert tcfg.plan is None and rcfg.plan is None and not tlog.lines


def _run(tmp_path, argv, capsys):
    gossip_sgd.main(BASE + ["--device", "cpu", "--world_size", "4",
                            "--checkpoint_dir", str(tmp_path)] + argv)
    out = capsys.readouterr().out
    plan = [json.loads(line.split("gossip plan: ", 1)[1])
            for line in out.splitlines() if "gossip plan: " in line]
    health = [json.loads(line.split("gossip health: ", 1)[1])
              for line in out.splitlines() if "gossip health: " in line]
    return plan, health


def _meta(tmp_path, rank=0):
    return json.loads(torch.load(os.path.join(
        tmp_path, f"checkpoint_r{rank}_n4.ckpt"), weights_only=True)["meta"])


@pytest.mark.parametrize("topology", [
    ["--topology", "hierarchical", "--slice_size", "2"],
    ["--topology", "synth", "--slice_size", "2", "--dcn_cost", "16"],
    ["--topology", "auto", "--slice_size", "2", "--dcn_cost", "16",
     "--overlap", "True", "--staleness", "2", "--wire_dtype", "int8",
     "--error_feedback", "True"],
], ids=["hierarchical", "synth", "auto-osgp-int8-ef"])
def test_tiny_runs_keep_push_sum_mass(tmp_path, capsys, topology):
    from stochastic_gradient_push_tpu.planner import (make_interconnect,
                                                      resolve_topology)
    from stochastic_gradient_push_tpu.run.gossip_sgd import (
        synth_plan_config)
    from stochastic_gradient_push_tpu.run.gossip_sgd import (
        parse_config as rparse)

    plan, health = _run(tmp_path, topology + ["--health_every", "1"],
                        capsys)
    assert len(plan) == 1 and len(health) == 2
    assert all(h["ps_mass_err"] == 0.0 for h in health)
    # the line is the reference planner's plan for the same flags
    _, args = rparse(BASE + topology + ["--world_size", "4"])
    want = resolve_topology(
        4, ppi=1, topology=args.topology, floor=args.gap_floor,
        interconnect=make_interconnect(args.slice_size, args.dcn_cost,
                                       args.ici_cost),
        overlap=args.overlap == "True",
        wire=({"dtype": "int8", "block": 64, "error_feedback": True}
              if args.wire_dtype == "int8" else None),
        synth=synth_plan_config(args))
    assert json.dumps(plan[0], sort_keys=True) == json.dumps(
        want.to_dict(), sort_keys=True)
    for rank in range(4):
        assert _meta(tmp_path, rank)["plan"] == plan[0]


def test_resume_replans_onto_the_stamped_fingerprint(tmp_path, capsys):
    synth = ["--topology", "synth", "--slice_size", "2", "--dcn_cost", "16"]
    first, _ = _run(tmp_path, synth, capsys)
    stamped = _meta(tmp_path)["plan"]["synth"]["fingerprint"]
    again, _ = _run(tmp_path, synth + ["--resume", "True", "--num_epochs",
                                       "2"], capsys)
    assert stamped == "b7e2ef83ed403b218f4f2f2ed6c019f7d194cca1"
    assert first[0]["synth"]["fingerprint"] == stamped
    assert again[0]["synth"]["fingerprint"] == stamped
    assert again[0] == first[0]
    meta = _meta(tmp_path)
    assert meta["epoch"] == 2 and meta["plan"] == again[0]


LM = ["--device", "cpu", "--vocab_size", "64", "--d_model", "16",
      "--n_layers", "1", "--n_heads", "1", "--d_ff", "32", "--seq_len", "16",
      "--batch_size", "2", "--num_steps", "2", "--print_freq", "1",
      "--corpus_tokens", "2000", "--world_size", "4"]


@pytest.mark.parametrize("argv", [
    ["--topology", "synth", "--slice_size", "2", "--dcn_cost", "16",
     "--health_every", "1"],
    ["--graph_type", "6"],
    ["--topology", "auto", "--mixing_alpha", "auto"],
], ids=["synth", "graph6", "auto-alpha"])
def test_lm_cli_plans_as_the_reference(argv, capsys, tmp_path):
    from stochastic_gradient_push_tpu.planner import (make_interconnect,
                                                      resolve_topology)
    from stochastic_gradient_push_tpu.topology import GRAPH_TOPOLOGIES

    result = gossip_lm.main(LM + argv + ["--checkpoint_dir", str(tmp_path)])
    assert np.isfinite(result["final_loss"])
    out = capsys.readouterr().out
    plan = [json.loads(line.split("gossip plan: ", 1)[1])
            for line in out.splitlines() if line.startswith("gossip plan: ")]
    args = gossip_lm.build_parser().parse_args(LM + argv)
    want = resolve_topology(
        4, ppi=1, topology=args.topology,
        graph_class=GRAPH_TOPOLOGIES[args.graph_type],
        self_weighted=args.mixing_alpha == "auto",
        interconnect=make_interconnect(args.slice_size, args.dcn_cost,
                                       args.ici_cost),
        synth={} if args.topology == "synth" else None)
    assert plan == [json.loads(json.dumps(want.to_dict()))]
    health = [json.loads(line.split("gossip health: ", 1)[1])
              for line in out.splitlines() if "gossip health: " in line]
    assert all(h["ps_mass_err"] == 0.0 for h in health)


def test_lm_cli_refusals(tmp_path):
    for argv, match in (
            (["--topology", "auto", "--world_size", "1"], "single-replica"),
            (["--topology", "auto", "--all_reduce", "True"],
             "does not apply to all_reduce"),
            (["--synth_seed", "2"], "need --topology synth"),
            (["--mixing_alpha", "0.5", "--push_sum", "False"],
             "needs push-sum")):
        with pytest.raises(SystemExit, match=match):
            with contextlib.redirect_stdout(io.StringIO()):
                gossip_lm.main(LM + argv
                               + ["--checkpoint_dir", str(tmp_path)])

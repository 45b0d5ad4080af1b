"""The LM command line's harness (``run/gossip_lm.py``), in one process on
the CPU, with the kernels' plain twins, at 2 layers, d32, seq 32:

* ``data/lm.py::load_corpus`` against the reference's, token for token
  (``.npy``, one-array ``.npz``, a byte file) and error for error; the
  synthetic corpus too, fresh and walked from a kept table.
* ``train/lm.py::build_lm_eval_step`` against ``jax.jit`` of the
  reference's eval step under ``shard_lm_eval_step``, flat dp 2 and dp 2
  x sp 2 ring, fp32 and bf16, on parameters whose ps-weights are not 1
  (so the de-biasing counts).  Tolerances are the LM step parity tests'
  on losses (``tests/test_torch_train_lm.py``): 1e-5 relative at fp32,
  ``BF16_LOSS_RTOL`` (2e-3) relative at bf16.
* Resume equals continue, exactly: N steps with ``--ckpt_every N/2``
  against N/2 steps then ``--resume True`` to N, every rank file's
  tensors and meta and every CSV row (less ``tokens_per_sec``) equal;
  world 4 flat and dp 2 x sp 2, fp32 and bf16, SGP and OSGP
  (``--staleness 2``, the FIFO drained in the files), and D-PSGD,
  AD-PSGD and AllReduce at world 4 flat.  The corpus is cut so the
  resumed data stream skips batches inside an epoch (and, flat, across
  one).
* Validation: the held-out split and its refusal, the ``--val_every``
  rule, validation rows at the cadence and at the end, and
  ``result["val_loss"]`` equal to the eval step's mean computed here.
* The CSV header rewrite on resume, ``already_complete``, the refusals
  (``--ckpt_backend orbax``, cross-world resume), the watchdog (armed
  from the second metrics fetch on) and the profile window (a trace of
  exactly its steps).

The runs in other processes (SIGUSR1, ``torchrun``) are in
``tests/test_torch_lm_harness_dist.py``.
"""

import contextlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.data import lm as tdata
from stochastic_gradient_push_torch.run import gossip_lm
import torch_lm_drive as drive
from torch_ckpt_sets import (assert_bit_equal, dcp_tensors, port_set,
                             reference_reshard)

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "1", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--print_freq", "1",
         "--warmup", "True", "--warmup_steps", "8",
         "--corpus_tokens", "4000"]
# 18 sequences of 32: 2 world-4 batches an epoch, 4 at dp 2
CORPUS = ["--corpus_tokens", "600"]
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = drive.BF16_LOSS_RTOL


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of a rank file's state (FIFO slots included)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_tensors(v, f"{prefix}/{i}"))
    else:
        out[prefix] = torch.as_tensor(tree)
    return out


def _files(directory):
    """Every rank file in ``directory``: ``{name: (tensors, meta)}``."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".ckpt"):
            blob = torch.load(os.path.join(directory, name),
                              weights_only=True)
            out[name] = (_tensors(blob["state"]), json.loads(blob["meta"]))
    return out


def _csv(directory, name="lm_out_n4.csv"):
    """The CSV's lines, ``tokens_per_sec`` (a host timing) left out."""
    with open(os.path.join(directory, name)) as f:
        lines = f.read().splitlines()
    return [lines[0]] + [",".join(r.split(",")[:4] + r.split(",")[5:])
                         for r in lines[1:]]


# -- load_corpus ---------------------------------------------------------


def _write_corpus(path, kind):
    r = np.random.default_rng(3)
    if kind == "npy":
        np.save(path, r.integers(0, 300, size=(7, 11)).astype(np.int64))
    elif kind == "npz":
        np.savez(path, toks=r.integers(0, 300, size=500).astype(np.int16))
    elif kind == "bytes":
        path.write_bytes(bytes(r.integers(0, 256, size=999, dtype=np.uint8)))
    elif kind == "npz_two":
        np.savez(path, a=np.arange(3), b=np.arange(4))
    elif kind == "float":
        np.save(path, r.standard_normal(8).astype(np.float32))
    elif kind == "out_of_range":
        np.save(path, np.array([0, 5, 300], np.int32))
    elif kind == "negative":
        np.save(path, np.array([3, -1], np.int32))


@pytest.mark.parametrize("kind,suffix,vocab", [
    ("npy", ".npy", 300), ("npz", ".npz", 300), ("bytes", ".txt", 256),
    ("bytes", ".bin", 1000)])
def test_load_corpus_matches_reference(tmp_path, kind, suffix, vocab):
    from stochastic_gradient_push_tpu.data.lm import load_corpus

    path = tmp_path / f"corpus{suffix}"
    _write_corpus(path, kind)
    got = tdata.load_corpus(str(path), vocab)
    want = load_corpus(str(path), vocab)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.size in (77, 500, 999)


@pytest.mark.parametrize("kind,suffix,vocab", [
    ("npz_two", ".npz", 300), ("float", ".npy", 300),
    ("out_of_range", ".npy", 300), ("negative", ".npy", 300),
    ("bytes", ".txt", 255)])
def test_load_corpus_refuses_as_the_reference(tmp_path, kind, suffix, vocab):
    from stochastic_gradient_push_tpu.data.lm import load_corpus

    path = tmp_path / f"corpus{suffix}"
    _write_corpus(path, kind)
    with pytest.raises(ValueError) as want:
        load_corpus(str(path), vocab)
    with pytest.raises(ValueError) as got:
        tdata.load_corpus(str(path), vocab)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,vocab,order,seed", [
    (3000, 256, 2, 47), (500, 300, 1, 0), (1000, 64, 3, 5)])
def test_synthetic_corpus_is_the_references_from_a_kept_table(n, vocab,
                                                              order, seed):
    """``synthetic_lm_corpus`` equals the reference's token for token, and
    so does a walk from a kept ``markov_table`` and its generator's state
    (``chip_smoke.py`` draws each table once this way)."""
    from stochastic_gradient_push_tpu.data.lm import synthetic_lm_corpus

    want = synthetic_lm_corpus(n, vocab_size=vocab, order=order, seed=seed)
    assert np.array_equal(tdata.synthetic_lm_corpus(
        n, vocab_size=vocab, order=order, seed=seed), want)
    table, g = tdata.markov_table(vocab, order, seed)
    state = g.bit_generator.state
    for _ in range(2):
        again = np.random.default_rng()
        again.bit_generator.state = state
        assert np.array_equal(tdata.markov_walk(table, again, n, vocab,
                                                order), want)


# -- the eval step against the reference ---------------------------------

VOCAB, D, L, H, FF, T, B = 64, 32, 2, 1, 64, 32, 2


def _debiased_start(host, dp, seed):
    """The reference's start state with rank-distinct numerators: each
    rank's params perturbed, then scaled by its ps-weight (0.75, 1.25,
    ...), so the de-biased parameters are the perturbed ones."""
    import jax

    r = np.random.default_rng(seed)
    w = (0.75 + 0.5 * np.arange(dp) / max(dp - 1, 1)).astype(np.float32)

    def scale(a):
        a = np.asarray(a, np.float32)
        noisy = a + 0.02 * r.standard_normal(a.shape).astype(np.float32)
        return noisy * w.reshape((dp,) + (1,) * (a.ndim - 1))

    return host.replace(params=jax.tree.map(scale, host.params),
                        gossip=host.gossip.replace(
                            ps_weight=w.reshape(
                                np.shape(host.gossip.ps_weight))))


def _jax_eval(dp, sp, dtype, batches):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu import algorithms as jalg
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import sgd as jsgd
    from stochastic_gradient_push_tpu.train.lm import (
        SEQ_AXIS, build_lm_eval_step, init_lm_state, make_dp_sp_mesh,
        shard_lm_eval_step)

    ring = sp > 1
    seq_axis = SEQ_AXIS if ring else None
    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                        d_ff=FF, max_len=T, attn_impl="ring" if ring
                        else "flash", seq_axis=seq_axis,
                        dtype=getattr(jnp, dtype)))
    mesh = make_dp_sp_mesh(dp, sp) if ring else make_gossip_mesh(dp)
    alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=1)), GOSSIP_AXIS)
    state = init_lm_state(model, mesh, alg, jsgd(momentum=0.9), dp=dp,
                          sp=sp, batch_size=B, block_len=T // sp, seed=0,
                          seq_axis=seq_axis)
    host = _debiased_start(jax.device_get(state), dp, seed=10 * dp + sp)
    state = jax.tree.map(lambda h, s: jax.device_put(h, s.sharding), host,
                         state)
    eval_fn = shard_lm_eval_step(build_lm_eval_step(model, alg, seq_axis),
                                 mesh, seq_axis=seq_axis)
    out = [jax.device_get(eval_fn(state, *(b if ring else b[:, 0]
                                           for b in batch)))
           for batch in batches]
    return host, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)], ids=["flat", "dp2xsp2"])
def test_eval_step_matches_reference(dp, sp, dtype):
    from stochastic_gradient_push_torch import algorithms as talg
    from stochastic_gradient_push_torch.models.convert import (
        train_state_from_jax)
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train import lm as tlm

    r = np.random.default_rng(5 + sp)
    batches = [tuple(r.integers(0, VOCAB, size=(dp, sp, B, T // sp))
                     .astype(np.int32) for _ in range(2)) for _ in range(2)]
    host, want = _jax_eval(dp, sp, dtype, batches)
    ring = sp > 1
    cfg = TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                            n_heads=H, d_ff=FF,
                            attn_impl="ring" if ring else "flash",
                            dtype=getattr(torch, dtype))
    alg = talg.sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1)), StackedTransport(dp))
    eval_step = tlm.build_lm_eval_step(tlm.make_model(cfg), alg,
                                       StackedSeq(sp) if ring else None)
    state = train_state_from_jax(host)
    assert not torch.equal(state.gossip.ps_weight, torch.ones(dp))
    rtol = LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    for batch, w in zip(batches, want):
        toks, tgts = (torch.from_numpy(b if ring else b[:, 0]).long()
                      for b in batch)
        got = eval_step(state, toks, tgts)
        assert got["loss"].shape == (dp,) and not got["loss"].requires_grad
        np.testing.assert_allclose(got["loss"].numpy(),
                                   np.asarray(w["loss"]).reshape(-1),
                                   rtol=rtol, atol=0)
        np.testing.assert_allclose(got["ppl"].numpy(),
                                   np.asarray(w["ppl"]).reshape(-1),
                                   rtol=2 * rtol, atol=0)
    # the eval step leaves the state alone
    again = train_state_from_jax(host)
    for n, p in state.params.items():
        assert torch.equal(p, again.params[n])


# -- resume equals continue ----------------------------------------------

FLAT, SP = ["--world_size", "4"], ["--world_size", "4", "--sp", "2"]
BF16 = ["--precision", "bf16"]
OSGP = ["--overlap", "True", "--staleness", "2", "--peers_per_itr", "2"]
RESUME_CASES = {
    "flat-fp32-sgp": FLAT, "flat-bf16-sgp": FLAT + BF16,
    "flat-fp32-osgp": FLAT + OSGP, "flat-bf16-osgp": FLAT + BF16 + OSGP,
    "sp-fp32-sgp": SP, "sp-bf16-sgp": SP + BF16,
    "sp-fp32-osgp": SP + OSGP[:4], "sp-bf16-osgp": SP + BF16 + OSGP[:4],
    "flat-dpsgd": FLAT + ["--push_sum", "False"],
    "flat-adpsgd": FLAT + ["--bilat", "True", "--graph_type", "1"],
    "flat-allreduce": FLAT + ["--all_reduce", "True"],
}
N = 6


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_equals_continue(case, tmp_path, capsys):
    argv = SMALL + CORPUS + RESUME_CASES[case] + ["--ckpt_every",
                                                  str(N // 2)]
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    gossip_lm.main(argv + ["--num_steps", str(N), "--checkpoint_dir",
                           straight])
    gossip_lm.main(argv + ["--num_steps", str(N // 2), "--checkpoint_dir",
                           split])
    result = gossip_lm.main(argv + ["--num_steps", str(N), "--resume",
                                    "True", "--checkpoint_dir", split])
    assert f"resumed from step {N // 2}" in capsys.readouterr().out
    assert np.isfinite(result["final_loss"])
    want, got = _files(straight), _files(split)
    dp = 2 if case.startswith("sp-") else 4
    assert sorted(got) == sorted(want) == [f"lm_checkpoint_r{r}_n4.ckpt"
                                           for r in range(dp)]
    for name, (w_t, w_meta) in want.items():
        g_t, g_meta = got[name]
        assert g_meta == w_meta and w_meta["step"] == N
        assert sorted(g_t) == sorted(w_t)
        for k in w_t:
            assert torch.equal(g_t[k], w_t[k]), (name, k)
        assert int(w_t["/step"]) == N
        if "osgp" in case:
            # the FIFO was drained into the params before each save
            fifo = [t for k, t in w_t.items() if "/in_flight/" in k]
            assert fifo and not any(t.any() for t in fifo)
    rows = _csv(split)
    assert rows == _csv(straight)
    assert [r.split(",")[0] for r in rows[1:]] == [str(i + 1)
                                                  for i in range(N)]


# -- validation ----------------------------------------------------------


@pytest.mark.parametrize("n,frac,min_val,n_val", [
    (1000, 0.1, 66, 100), (1000, 0.01, 66, 66), (1000, 0.45, 66, 450)])
def test_split_holds_out_the_tail(n, frac, min_val, n_val):
    corpus = np.arange(n)
    train, val = gossip_lm.split_corpus(corpus, frac, min_val)
    assert len(val) == n_val and len(train) == n - n_val
    np.testing.assert_array_equal(np.concatenate([train, val]), corpus)
    assert gossip_lm.split_corpus(corpus, 0.0, min_val)[1] is None


@pytest.mark.parametrize("argv,match", [
    (["--val_frac", "0.5", "--corpus_tokens", "1000"],
     "--val_frac leaves too little training data"),
    (["--val_frac", "0.01", "--corpus_tokens", "250"],
     "--val_frac leaves too little"),
    (["--val_frac", "0.1", "--val_every", "3", "--print_freq", "2"],
     "--val_every 3 must be a multiple of --print_freq 2"),
])
def test_validation_flags_are_checked(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + ["--world_size", "2", "--num_steps", "2",
                                "--checkpoint_dir", str(tmp_path)] + argv)


def test_validation_rows_and_loss(tmp_path, capsys):
    from stochastic_gradient_push_torch import algorithms as talg
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train import lm as tlm
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)

    dp, tokens, frac, n_batches = 2, 3000, 0.2, 2
    result = gossip_lm.main(SMALL + [
        "--world_size", str(dp), "--num_steps", "5", "--corpus_tokens",
        str(tokens), "--val_frac", str(frac), "--val_every", "2",
        "--val_batches", str(n_batches), "--all_reduce", "True",
        "--checkpoint_dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    head = out.index("step,loss,ppl,lr,tokens_per_sec,grad_norm,val_loss,"
                     "val_ppl")
    rows = [r.split(",") for r in out[head + 1:head + 6]]
    assert [r[0] for r in rows] == ["1", "2", "3", "4", "5"]
    assert [bool(r[6]) for r in rows] == [False, True, False, True, True]
    assert all(len(r) == 8 for r in rows)
    assert rows[-1][6] == f"{result['val_loss']:.4f}"
    with open(tmp_path / "lm_out_n2.csv") as f:
        assert f.read().splitlines() == out[head:head + 6]

    # the eval step on the saved final state (the one validated at step
    # 5), over the held-out tail's first batches
    corpus = tdata.synthetic_lm_corpus(tokens, vocab_size=256, seed=47)
    n_val = max(int(tokens * frac), (32 + 1) * dp * 2)
    val = corpus[-n_val:]
    cfg = TransformerConfig(vocab_size=256, d_model=32, n_layers=2,
                            n_heads=1, d_ff=64, attn_impl="flash")
    transport = StackedTransport(dp)
    alg = talg.all_reduce(transport)
    tx = sgd(momentum=0.9)
    state, _ = CheckpointManager(str(tmp_path), tag="lm_", world_size=dp,
                                 ranks=range(dp)).restore(
        tlm.init_lm_state(cfg, alg, tx, dp))
    eval_step = tlm.build_lm_eval_step(tlm.make_model(cfg), alg)
    vals = []
    for vt, vy in tdata.lm_batches(val, dp, 1, 2, 32, seed=1):
        m = eval_step(state, torch.from_numpy(vt[:, 0]),
                      torch.from_numpy(vy[:, 0]))
        vals.append(float(transport.allreduce_sum(m["loss"])[0] / dp))
        if len(vals) >= n_batches:
            break
    assert result["val_loss"] == float(np.mean(vals))


# -- the CSV, already_complete, refusals ----------------------------------


def test_resume_rewrites_an_older_csv_header(tmp_path, capsys):
    argv = SMALL + ["--world_size", "2", "--checkpoint_dir", str(tmp_path),
                    "--val_frac", "0.1"]
    gossip_lm.main(argv + ["--num_steps", "2"])
    path = tmp_path / "lm_out_n2.csv"
    # an older schema: no grad_norm or val_ppl, val_loss beside the time
    path.write_text("step,loss,ppl,lr,tokens_per_sec,val_loss\n"
                    "1,5.1,160.0,0.01,99,\n2,5.0,150.0,0.01,98,5.2\n")
    gossip_lm.main(argv + ["--num_steps", "3", "--resume", "True"])
    assert "existing CSV header" in capsys.readouterr().out
    lines = path.read_text().splitlines()
    assert lines[0] == ("step,loss,ppl,lr,tokens_per_sec,grad_norm,"
                        "val_loss,val_ppl")
    assert lines[1:3] == ["1,5.1,160.0,0.01,99,,,",
                          "2,5.0,150.0,0.01,98,,5.2,"]
    assert lines[3].startswith("3,") and len(lines) == 4
    assert not (tmp_path / "lm_out_n2.csv.tmp").exists()


@pytest.mark.parametrize("num_steps", [2, 1])
def test_resume_at_or_past_the_end_is_already_complete(tmp_path, num_steps):
    argv = SMALL + ["--world_size", "2", "--checkpoint_dir", str(tmp_path)]
    gossip_lm.main(argv + ["--num_steps", "2"])
    before = (tmp_path / "lm_out_n2.csv").read_text()
    result = gossip_lm.main(argv + ["--num_steps", str(num_steps),
                                    "--resume", "True"])
    assert result == {"final_loss": None, "avg_loss": None,
                      "tokens_per_sec": 0.0, "already_complete": True}
    assert (tmp_path / "lm_out_n2.csv").read_text() == before


def test_orbax_backend_is_refused_by_name(tmp_path):
    # --ckpt_backend orbax (torch.distributed.checkpoint) trains and
    # saves; its checkpoints of another world are refused, naming it
    argv = SMALL + ["--num_steps", "1", "--ckpt_backend", "orbax",
                    "--checkpoint_dir", str(tmp_path)]
    gossip_lm.main(argv + ["--world_size", "2"])
    assert sorted(os.listdir(tmp_path)) == ["lm_dcp_r0_n2", "lm_out_n2.csv"]
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .*--ckpt_backend orbax "
                             r".* world \[2\], not 4"):
        gossip_lm.main(argv + ["--world_size", "4", "--resume", "True"])


def test_cross_world_resume_is_refused_by_name(tmp_path):
    # the reference reshards a flat mesh in one process only: --sp 2
    # keeps a replica's sequence shards in its file
    argv = SMALL + ["--num_steps", "1", "--checkpoint_dir", str(tmp_path)]
    gossip_lm.main(argv + ["--world_size", "2"])
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .* world \[2\], not 4, "
                             r"and --sp 2 > 1"):
        gossip_lm.main(argv + ["--world_size", "4", "--sp", "2",
                               "--resume", "True"])


@pytest.mark.parametrize("extra", [[], BF16 + OSGP[:4]],
                         ids=["fp32-sgp", "bf16-osgp"])
def test_resume_at_another_world_reshards(extra, tmp_path, capsys):
    """World 4 for 3 steps, resumed at world 2: the resharded files are
    the reference's reshard of the port's world-4 files, bit for bit, and
    the resumed run equals a same-world resume from them."""
    argv = SMALL + CORPUS + extra
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    gossip_lm.main(argv + ["--world_size", "4", "--num_steps", "3",
                           "--checkpoint_dir", a])
    shutil.copytree(a, b)
    want = reference_reshard(a, "lm_", 4, 2)
    new = argv + ["--world_size", "2", "--resume", "True"]
    # resumed at its last step: the reshard writes the set, no step runs
    assert gossip_lm.main(new + ["--num_steps", "3", "--checkpoint_dir",
                                 a])["already_complete"]
    assert "resharded checkpoint set n=4 -> n=2" in capsys.readouterr().out
    assert_bit_equal(port_set(a, "lm_", 2), want)
    gossip_lm.main(new + ["--num_steps", "6", "--checkpoint_dir", a])
    gossip_lm.main(new + ["--num_steps", "6", "--checkpoint_dir", b])
    got, ref = _files(a), _files(b)
    names = ["lm_checkpoint_r0_n2.ckpt", "lm_checkpoint_r1_n2.ckpt"]
    assert [n for n in got if n in names] == names
    for name in names:
        g_t, g_meta = got[name]
        w_t, w_meta = ref[name]
        assert g_meta["step"] == w_meta["step"] == 6
        assert sorted(g_t) == sorted(w_t)
        for k in w_t:
            assert torch.equal(g_t[k], w_t[k]), (name, k)
    assert _csv(a, "lm_out_n2.csv") == _csv(b, "lm_out_n2.csv")


def test_resume_under_the_dcp_backend_equals_the_rank_files(tmp_path):
    """--ckpt_backend orbax, keyed by step, against the per-rank files
    (the reference's tests/test_transformer_lm.py:222): 3 steps, then a
    resume to 6, equal rows and states."""
    argv = SMALL + CORPUS + ["--world_size", "4", "--ckpt_every", "1",
                             "--overlap", "True", "--staleness", "2"]
    for backend in ("msgpack", "orbax"):
        d = str(tmp_path / backend)
        flags = ["--ckpt_backend", backend, "--checkpoint_dir", d]
        gossip_lm.main(argv + flags + ["--num_steps", "3"])
        gossip_lm.main(argv + flags + ["--num_steps", "6", "--resume",
                                       "True"])
    root = tmp_path / "orbax" / "lm_dcp_r0_n4"
    # saves keyed by step, the newest 3 kept
    assert sorted(os.listdir(root)) == ["4", "5", "6", "best"]
    got = dcp_tensors(root / "6")
    files = _files(str(tmp_path / "msgpack"))
    for r in range(4):
        tensors, meta = files[f"lm_checkpoint_r{r}_n4.ckpt"]
        assert meta["step"] == 6
        for k, t in tensors.items():
            if k.startswith("/params/"):
                assert torch.equal(got["state.params." + k[8:]][r], t), k
            elif k.startswith("/opt_state/"):
                assert torch.equal(got["state.opt_state." + k[11:]][r], t), k
    assert _csv(str(tmp_path / "orbax")) == _csv(str(tmp_path / "msgpack"))


def test_every_run_writes_its_files(tmp_path):
    gossip_lm.main(SMALL + ["--world_size", "4", "--sp", "2", "--num_steps",
                            "2", "--tag", "x_", "--checkpoint_dir",
                            str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == [
        "x_checkpoint_r0_n4.ckpt", "x_checkpoint_r1_n4.ckpt",
        "x_out_n4.csv"]


# -- the watchdog and the profile window ----------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stalling_watchdog(made):
    """A ``StepWatchdog`` whose every guarded fetch stalls past its
    timeout on an injected clock, until the watcher has fired."""
    import time

    from stochastic_gradient_push_torch.utils.profiling import StepWatchdog

    class Stalling(StepWatchdog):
        def __init__(self, timeout, rank=0, **kw):
            self.fake = _Clock()
            super().__init__(timeout, rank=rank, clock=self.fake,
                             poll_s=0.005, **kw)
            made.append(self)

        @contextlib.contextmanager
        def step(self):
            with super().step():
                self.timed_out = False
                self.fake.t += self.timeout + 1
                deadline = time.monotonic() + 5
                while not self.timed_out and time.monotonic() < deadline:
                    time.sleep(0.005)
                yield

    return Stalling


def test_watchdog_guards_every_fetch_but_the_first(tmp_path, capsys,
                                                   monkeypatch):
    from stochastic_gradient_push_torch.utils import profiling

    made = []
    monkeypatch.setattr(profiling, "StepWatchdog", _stalling_watchdog(made))
    gossip_lm.main(SMALL + ["--world_size", "2", "--num_steps", "3",
                            "--heartbeat_timeout", "7", "--checkpoint_dir",
                            str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    fired = [i for i, line in enumerate(out)
             if "step exceeded heartbeat timeout (8s > 7s)" in line]
    rows = {line.split(",")[0]: i for i, line in enumerate(out)
            if line[:2] in ("1,", "2,", "3,")}
    assert len(made) == 1 and len(fired) == 2
    # never around the first fetch (the warm-up): after row 1, and one
    # before each later row
    assert rows["1"] < fired[0] < rows["2"] < fired[1] < rows["3"]
    made.clear()
    gossip_lm.main(SMALL + ["--world_size", "2", "--num_steps", "2",
                            "--heartbeat_timeout", "0", "--checkpoint_dir",
                            str(tmp_path / "off")])
    assert not made


def test_profile_window_traces_exactly_its_steps(tmp_path):
    prof = tmp_path / "prof"
    result = gossip_lm.main(SMALL + [
        "--world_size", "2", "--num_steps", "5", "--profile_dir", str(prof),
        "--profile_start_step", "2", "--profile_steps", "2",
        "--checkpoint_dir", str(tmp_path)])
    assert result["profile_trace"] == str(prof / "trace_r0_steps2-3.json")
    with open(result["profile_trace"]) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events
                   if str(e.get("name", "")).startswith("lm_step_"))
    assert steps == ["lm_step_2", "lm_step_3"]


@pytest.mark.parametrize("argv,match", [
    (["--profile_steps", "2"], "need --profile_dir"),
    (["--profile_dir", "p", "--profile_steps", "0"], "profile_steps must"),
    (["--heartbeat_timeout", "-1"], "--heartbeat_timeout must be >= 0"),
])
def test_harness_flags_are_checked(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + ["--checkpoint_dir", str(tmp_path)] + argv)

"""Tensor parallelism on head counts ``--tp`` does not divide: the
reference's GSPMD splits each kernel's columns, not its heads, so a head
may straddle two tp shards (``--tp 2 --n_heads 3 --d_model 24`` gives
each shard one and a half heads of 8 columns; ``--tp 4 --n_heads 3``
fewer heads than shards).  The reference trains whenever ``d_model``,
``d_ff`` and ``vocab_size`` divide by ``tp``, whatever ``n_heads`` is,
and refuses the rest (``init_lm_state_tp``'s uneven split).

* **Against the reference** (the reference's own command-line shapes:
  ``n_heads 3, d_model 24`` at tp 2 and tp 4, ``n_heads 6, d_model 36``
  at tp 4), on every tp mesh it builds: dense ``(gossip, tp)``, ``(gossip,
  seq, tp)`` with ring attention and ``(gossip, ep, tp)`` with switch
  MoE.  Two SGP steps of the port's stacked lane (``StackedTp``, the
  held shards' columns joined into whole heads, ``parallel/tp.py::
  _TpAxis.join_heads``) against the reference's compiled step from the
  same start: ``test_torch_tp.py``'s tolerances (losses 1e-5 relative,
  grad norms 1e-4 relative, params atol 2e-6, the push-sum weight
  exactly; ``moe_dropped`` exactly, the router's top-1 / top-2 margin
  asserted above 1e-6).  Momentum is held to an fp64 run of the port's
  step (``torch_lm_drive.assert_momentum``'s rule: no farther from it
  than twice the reference, plus 1e-7): in the embedding rows both
  frameworks sit 1.2-3.4e-6 from it, on either side.
* **Against the port's tp 1**, at the same shapes: the flash
  attention's plain twin and remat see the same heads (fp32 sums
  reordered only: losses 1e-5 relative, grad norms 1e-4, params 2e-6).
* **Across processes**: ``test_torch_tp_heads_dist.py``.
* **Refusals**: ``d_model``, ``d_ff`` and ``vocab_size`` that ``tp``
  does not divide are refused by name, by ``check_tp_dims``, the
  model's config and the command line.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig, TransformerLM)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import StackedEp
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import (
    StackedTp, check_tp_dims, gather_params, shard_state)
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
import torch_ep_drive as ep_drive
import torch_lm_drive as lm_drive

VOCAB, L, FF, T, B = ep_drive.VOCAB, ep_drive.L, 32, ep_drive.T, ep_drive.B
STEPS = 2
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
MARGIN = 1e-6

# (mesh, dp, sp, ep, tp, n_heads, d_model, experts): the reference's
# runs that train, each on 8 CPU devices
CASES = {
    "tp2_h3_d24": ("dense", 4, 1, 1, 2, 3, 24, 0),
    "tp4_h3_d24": ("dense", 2, 1, 1, 4, 3, 24, 0),
    "tp4_h6_d36": ("dense", 2, 1, 1, 4, 6, 36, 0),
    "sp2_tp2_ring_h3_d24": ("ring", 2, 2, 1, 2, 3, 24, 0),
    "ep2_tp2_moe_h3_d24": ("moe", 2, 1, 2, 2, 3, 24, 2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def config(tp, h, d, impl="full", experts=0, ep=1, remat=False,
           dtype=torch.float32):
    return TransformerConfig(vocab_size=VOCAB, d_model=d, n_layers=L,
                             n_heads=h, d_ff=FF, attn_impl=impl,
                             remat=remat, dtype=dtype, moe_experts=experts,
                             moe_every=2, ep=ep, tp=tp)


@contextlib.contextmanager
def _shape(h, d):
    """``torch_ep_drive``'s model at ``h`` heads and width ``d`` (its
    reference run reads the module's sizes)."""
    old = ep_drive.H, ep_drive.D
    ep_drive.H, ep_drive.D = h, d
    try:
        yield
    finally:
        ep_drive.H, ep_drive.D = old


def _reference(case):
    _, dp, sp, ep, tp, h, d, experts = CASES[case]
    data = ep_drive.batches(dp, ep, sp, 21, steps=STEPS)
    with _shape(h, d):
        start, end, metrics = ep_drive.jax_run(dp, ep, sp, data, tp=tp,
                                               experts=experts, ff=FF)
    return data, start, end, metrics


def port_run(cfg, dp, sp, data, transport=None, seq=None, tp=None,
             ep=None, start=None, name="sgp") -> dict:
    """``len(data)`` SGP steps of the port from ``start`` (logical
    leaves, placed for ``tp``) or the seed-0 init over ``data`` (``[dp,
    ep, sp, B, t]`` batches; this process's rows, ep and sequence shards
    of them), then the eval step on the first batch: each held replica's
    metrics a step, the params and momentum as held, the push-sum weight
    and the eval loss."""
    transport = transport or StackedTransport(dp)
    alg = (talg.osgp if name == "osgp" else talg.sgp)(build_schedule(
        NPeerDynamicDirectedExponentialGraph(dp, peers_per_itr=1)),
        transport)
    model = tlm.make_model(cfg)
    tx = sgd(0.9, 1e-4, nesterov=True)
    step = tlm.build_lm_train_step(
        model, alg, tx, LRSchedule(0.5, B, dp * cfg.ep, decay_schedule={},
                                   warmup=True),
        itr_per_epoch=2, seq=seq, tp=tp, ep=ep)
    if start is None:
        state = tlm.init_lm_state(cfg, alg, tx, len(transport.ranks),
                                  seed=0, tp=tp, ep=ep)
    else:
        state = shard_state(start, tp.size) if tp is not None else start
    ep_shards = (0,) if ep is None else ep.shards
    seq_shards = range(sp) if seq is None else seq.shards

    def mine(pair):
        got = [ep_drive.local(a, transport.ranks, ep_shards, sp, seq_shards)
               for a in pair]
        return got if ep is not None else [g[:, 0] for g in got]

    out = {}
    for i, pair in enumerate(data):
        state, m = step(state, *mine(pair))
        for k in ("loss", "ppl", "grad_norm", "moe_dropped"):
            if k in m:
                out[f"{k}/{i}"] = m[k].detach().numpy()
    for n, p in state.params.items():
        out[f"params/{n}"] = p.numpy()
    for n, p in state.opt_state.items():
        out[f"momentum/{n}"] = p.numpy()
    out["ps_weight"] = state.gossip.ps_weight.numpy()
    ev = tlm.build_lm_eval_step(model, alg, seq, tp, ep)(state,
                                                         *mine(data[0]))
    out["eval_loss"] = ev["loss"].numpy()
    return out


def _logical(out: dict, part: str, tp: int) -> dict:
    tree = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(part + "/")}
    return gather_params(tree, tp) if tp > 1 else tree


def _margin(start, data, dp, ep, h, d, experts) -> float:
    """The smallest top-1 / top-2 router probability gap over the first
    batch's tokens at the start parameters (the port's tp 1 model)."""
    model = TransformerLM(config(1, h, d, experts=experts))
    got = []
    model.block_1.moe.register_forward_hook(
        lambda mod, args, out: got.append(args[0]))
    toks = data[0][0]
    gaps = []
    for r in range(dp):
        model.load_state_dict({n: p[r] for n, p in start.params.items()})
        for e in range(ep):
            got.clear()
            with torch.no_grad():
                model(torch.from_numpy(toks[r, e, 0]).long())
                probs = torch.softmax(got[0] @ model.block_1.moe.router, -1)
            top = probs.topk(2, -1).values
            gaps.append(float((top[..., 0] - top[..., 1]).min()))
    return min(gaps)


# -- against the reference ------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_steps_match_the_reference(case):
    mesh, dp, sp, ep, tp, h, d, experts = CASES[case]
    data, start, end, want = _reference(case)
    begin = train_state_from_jax(start)
    if experts:
        assert _margin(begin, data, dp, ep, h, d, experts) > MARGIN
    cfg = config(tp, h, d, "ring" if sp > 1 else "full", experts, ep)
    got = port_run(cfg, dp, sp, data, seq=StackedSeq(sp) if sp > 1 else None,
                   tp=StackedTp(tp), ep=StackedEp(ep) if ep > 1 else None,
                   start=begin)
    for i, m in enumerate(want):
        for k, rtol in (("loss", LOSS_RTOL), ("ppl", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(got[f"{k}/{i}"],
                                       np.asarray(m[k]).reshape(-1),
                                       rtol=rtol, atol=0, err_msg=k)
        if experts:
            assert np.array_equal(got[f"moe_dropped/{i}"],
                                  np.asarray(m["moe_dropped"]).reshape(-1))
    ref = train_state_from_jax(end)
    params, momentum = (_logical(got, part, tp)
                        for part in ("params", "momentum"))
    for n, w in ref.params.items():
        np.testing.assert_allclose(params[n].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    # momentum: in the embedding rows many tokens hit both frameworks sit
    # 1.2-3.4e-6 from an fp64 run of the port's step, on either side of
    # it (5.6e-6 apart at tp2_h3_d24), so it is held to that oracle as
    # torch_lm_drive.assert_momentum holds it: no farther from the fp64
    # run than twice the reference, plus 1e-7
    exact = port_run(dataclasses.replace(cfg, dtype=torch.float64, tp=1),
                     dp, sp, data, seq=StackedSeq(sp) if sp > 1 else None,
                     ep=StackedEp(ep) if ep > 1 else None,
                     start=lm_drive.fp64_state(begin))
    exact = _logical(exact, "momentum", 1)
    assert lm_drive.tree_err(momentum, exact) <= 2 * lm_drive.tree_err(
        ref.opt_state, exact) + 1e-7
    assert np.array_equal(got["ps_weight"], ref.gossip.ps_weight.numpy())


# -- against the port's tp 1 ------------------------------------------------


@pytest.mark.parametrize("impl,remat,tp,h,d", [
    ("flash", False, 2, 3, 24),
    ("flash", True, 4, 3, 24),
    ("full", True, 4, 6, 36),
    ("blockwise", False, 2, 3, 24),
])
def test_straddling_heads_equal_tp1(impl, remat, tp, h, d):
    dp = 2
    data = ep_drive.batches(dp, 1, 1, 23, steps=STEPS)
    want = port_run(config(1, h, d, impl, remat=remat), dp, 1, data)
    got = port_run(config(tp, h, d, impl, remat=remat), dp, 1, data,
                   tp=StackedTp(tp))
    for k in want:
        part = k.split("/")[0]
        if part in ("params", "momentum"):
            continue
        if part == "ps_weight":
            assert np.array_equal(got[k], want[k])
            continue
        rtol = GN_RTOL if part == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)
    for part in ("params", "momentum"):
        g, w = _logical(got, part, tp), _logical(want, part, 1)
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), w[n].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)


def test_the_stack_joins_every_head_into_one_attention():
    """Stacked, the held shards' columns join into all ``n_heads``
    heads: one attention call a layer over tp 1's heads."""
    from stochastic_gradient_push_torch.models import transformer

    calls = []
    real = transformer.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    transformer.flash_attention = spy
    try:
        port_run(config(4, 3, 24, "flash"), 2, 1,
                 ep_drive.batches(2, 1, 1, 23, steps=1), tp=StackedTp(4))
    finally:
        transformer.flash_attention = real
    # one train step and the eval step of 2 replicas, L layers each
    assert calls == [(B, 3, T, 8)] * (2 * L * 2)


@pytest.mark.parametrize("tp,shard,span", [
    (2, 0, (0, 16)), (2, 1, (8, 24)),
    (4, 0, (0, 8)), (4, 1, (0, 16)), (4, 2, (8, 24)), (4, 3, (16, 24)),
])
def test_a_shard_touches_the_heads_its_columns_cut(tp, shard, span):
    """At ``d_model 24``, 3 heads of 8: a tp shard's ``24 / tp`` columns
    and the whole heads they touch."""
    class One(StackedTp):
        pass

    ax = One(tp)
    ax.shards = (shard,)
    assert ax.head_span(24, 8) == span
    assert StackedTp(tp).head_span(24, 8) == (0, 24)


# -- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("dims,match", [
    ((30, 64, 64), "d_model 30 not divisible by tp 4"),
    ((24, 65, 64), "d_ff 65 not divisible by tp 4"),
    ((24, 64, 65), "vocab_size 65 not divisible by tp 4"),
])
def test_non_dividing_kernel_dims_are_refused_by_name(tmp_path, dims, match):
    d, f, v = dims
    with pytest.raises(ValueError, match=match):
        check_tp_dims(d, f, v, 4)
    with pytest.raises(ValueError, match=match):
        TransformerConfig(vocab_size=v, d_model=d, n_layers=1, n_heads=3,
                          d_ff=f, tp=4)
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(["--device", "cpu", "--world_size", "8", "--tp", "4",
                        "--n_heads", "3", "--d_model", str(d), "--d_ff",
                        str(f), "--vocab_size", str(v), "--n_layers", "1",
                        "--seq_len", "16", "--batch_size", "2",
                        "--num_steps", "1", "--corpus_tokens", "2000",
                        "--checkpoint_dir", str(tmp_path)])


def _rows(out: str) -> list:
    return [line.split(",")[:3] for line in out.splitlines()
            if line.split(",")[0].isdigit()]


def test_cli_trains_fewer_heads_than_shards(tmp_path, capsys):
    """``--tp 4 --n_heads 3``: each process's columns cut a head; the
    rows are ``--tp 1``'s (loss, ppl to their printed digits)."""
    base = ["--device", "cpu", "--n_heads", "3", "--d_model", "24",
            "--d_ff", "32", "--vocab_size", "64", "--n_layers", "2",
            "--seq_len", "16", "--batch_size", "2", "--num_steps", "3",
            "--print_freq", "1", "--corpus_tokens", "4000"]
    runs = {}
    for world, tp in ((2, 1), (8, 4)):
        gossip_lm.main(base + ["--world_size", str(world), "--tp", str(tp),
                               "--checkpoint_dir", str(tmp_path / str(tp))])
        runs[tp] = _rows(capsys.readouterr().out)
    assert len(runs[1]) == 3
    for a, b in zip(runs[1], runs[4]):
        assert a[0] == b[0]
        np.testing.assert_allclose([float(x) for x in b[1:]],
                                   [float(x) for x in a[1:]], rtol=1e-5)

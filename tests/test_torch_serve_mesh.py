"""Port parity: the serving remainder of ``stochastic_gradient_push_torch``
against the JAX package's, on the CPU (the kernels' plain twins).

* ``SyntheticEngine``: tokens and page ids equal the reference's for one
  seed and request stream, and so do ``run_bench``'s completions;
* the decode placement (``decode_partition_rules``,
  ``match_partition_rules``, the split dim after the fallback) equals the
  reference's on a d64/L2/h4 tree at 1, 2 and 4 shards and at a ``d_ff``
  4 does not divide;
* ``sharded_paged_decode`` over 2 and 4 shards equals the unsharded
  ``paged_attention_reference`` bit for bit, and the reference's on a
  2-device CPU mesh (its jnp lane) within 1e-6;
* the engine at one shard: the whole model's forward passes, bit for bit;
* the KV-head-sharded engine: greedy tokens equal the unsharded engine's
  and the reference's ``LMEngine(mesh=...)`` on the same weights (prompts
  <= 128 tokens), logits within ``SHARD_ATOL`` of the unsharded engine's,
  and 2 gloo processes (``DistTp``) bit-equal to the stacked engine:
  tokens, logits and page ids;
* the serve CLI: a run directory (``--tag``, ``--world``), the
  ``SyntheticEngine`` fallback with the reference's digest seed,
  ``--model_shards``, ``--trace_dir`` events the port's ``EVENT_KINDS``
  accept, ``--selftest``, and exit codes 0/1/2.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models.convert import init_params
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig, TransformerLM, rope, rope_tok)
from stochastic_gradient_push_torch.ops.flash_attention import (
    flash_attention)
from stochastic_gradient_push_torch.serve import bench as tbench
from stochastic_gradient_push_torch.serve import cli
from stochastic_gradient_push_torch.serve import load as tload
from stochastic_gradient_push_torch.serve.engine import LMEngine, ServeConfig
from stochastic_gradient_push_torch.serve.paged_attention import (
    paged_attention_decode, paged_attention_reference, sharded_paged_decode)

sys.path.insert(0, str(Path(__file__).parent))
from torch_launch import TIMEOUT, torchrun  # noqa: E402

torch.set_num_threads(1)
REPO = str(Path(__file__).resolve().parents[1])

# fp32 logits of the sharded engine against the unsharded one: the o and
# down sums fold two (four) partial products instead of one GEMM's sum
SHARD_ATOL = 1e-5
# the reference's sharded decode (jnp lane, one CPU device a shard)
# against the port's head slices
MESH_ATOL = 1e-6

TINY = TransformerConfig(vocab_size=48, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64)
KW = dict(n_heads=4, page_size=4, num_pages=24, max_seqs=3,
          max_pages_per_seq=6)


# -- SyntheticEngine -------------------------------------------------------------


def _trace(engine, prompts):
    """Start each prompt, step them all three times, finish them: the
    tokens and the page ids of every slot."""
    out, slots = [], []
    for p in prompts:
        slot, tok = engine.start(list(p), len(p) + 4)
        slots.append(slot)
        out.append(("start", slot, tok, tuple(engine.pages.pages_of(slot))))
    for _ in range(3):
        step = engine.step(slots)
        out.append(("step", sorted(step.items()),
                    [tuple(engine.pages.pages_of(s)) for s in slots]))
    for s in slots:
        engine.finish(s)
    engine.pages.assert_quiescent()
    return out


@pytest.mark.parametrize("seed,vocab", [(0, 256), (1397877, 64)])
def test_synthetic_engine_tokens_and_pages_equal_the_reference(seed, vocab):
    from stochastic_gradient_push_tpu.serve.bench import (
        SyntheticEngine as JaxSynthetic)
    from stochastic_gradient_push_tpu.serve.engine import (
        ServeConfig as JaxServeConfig)

    prompts = [[5, 11, 3], [7, 2, 9, 4, 1, 1], [30]]
    want = _trace(JaxSynthetic(JaxServeConfig(**KW), vocab=vocab,
                               seed=seed), prompts)
    got = _trace(tbench.SyntheticEngine(ServeConfig(**KW), vocab=vocab,
                                        seed=seed), prompts)
    assert got == want


def test_run_bench_over_the_synthetic_engine_equals_the_reference():
    from stochastic_gradient_push_tpu.serve import bench as jbench
    from stochastic_gradient_push_tpu.serve.engine import (
        ServeConfig as JaxServeConfig)

    stream = dict(seed=3, vocab=256, prompt_tokens=(2, 12),
                  new_tokens=(1, 8))
    jm, jc = jbench.run_bench(
        jbench.SyntheticEngine(JaxServeConfig(**KW), seed=11,
                               kv_bytes_per_tok=7),
        jbench.synthetic_requests(40, **stream))
    tm, tc = tbench.run_bench(
        tbench.SyntheticEngine(ServeConfig(**KW), seed=11,
                               kv_bytes_per_tok=7),
        tbench.synthetic_requests(40, **stream))
    assert {c.rid: c.tokens for c in tc} == {c.rid: c.tokens for c in jc}
    for key in ("requests", "tokens", "decode_steps", "kv_bytes_per_token",
                "page_occupancy_peak", "admission_rejections"):
        assert tm[key] == jm[key], key


# -- the decode placement ------------------------------------------------------


def _tree(d_ff=128, seed=0):
    return init_params(TransformerConfig(vocab_size=64, d_model=64,
                                         n_layers=2, n_heads=4, d_ff=d_ff),
                       seed=seed)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_partition_rules_and_specs_equal_the_reference():
    from stochastic_gradient_push_tpu.serve.load import (
        decode_partition_rules, match_partition_rules)

    ref_rules = decode_partition_rules()
    port_rules = tload.decode_partition_rules()
    assert [(r, tuple(s)) for r, s in ref_rules] == list(port_rules)
    params = _tree()
    want = match_partition_rules(ref_rules, params)
    got = tload.match_partition_rules(port_rules, params)
    for path, spec in _leaves(got):
        assert spec == tuple(_at(want, path)), path


@pytest.mark.parametrize("shards,d_ff", [(1, 128), (2, 128), (4, 128),
                                         (4, 98)],
                         ids=["1", "2", "4", "4-ff98-fallback"])
def test_placement_equals_the_references_on_a_model_mesh(shards, d_ff):
    import jax
    from jax.sharding import Mesh

    from stochastic_gradient_push_tpu.serve.load import (
        shard_params_for_decode)

    params = _tree(d_ff)
    mesh = Mesh(np.array(jax.devices()[:shards]), ("model",))
    placed = shard_params_for_decode(params, mesh)
    dims = tload.decode_placement(params, shards)
    parts = tload.shard_params_for_decode(params, shards)
    for path, leaf in _leaves(params):
        spec = tuple(_at(placed, path).sharding.spec)
        want = next((d for d, a in enumerate(spec) if a is not None), None)
        got = _at(dims, path)
        assert got == (want if shards > 1 else None), (path, spec)
        blocks = [np.asarray(_at(p, path)) for p in parts]
        whole = (np.asarray(leaf) if got is None
                 else np.concatenate(blocks, axis=got))
        np.testing.assert_array_equal(whole, leaf)
    if d_ff == 98:
        assert _at(dims, ("block_0", "up", "kernel")) is None
        assert _at(dims, ("block_0", "attn", "q", "kernel")) == 1


def test_a_leaf_no_rule_matches_is_typed():
    rules = tuple(r for r in tload.decode_partition_rules() if r[0] != ".*")
    with pytest.raises(tload.ConsensusIngestError,
                       match="no partition rule matches param 'embed/"
                             "embedding'"):
        tload.match_partition_rules(rules, _tree())


# -- the sharded paged decode --------------------------------------------------


def _paged_case(seed, b=4, hq=8, hkv=4, np_=9, page=4, max_pages=5, d=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, d)).astype(np.float32)
    kp = r.standard_normal((hkv, np_, page, d)).astype(np.float32)
    vp = r.standard_normal((hkv, np_, page, d)).astype(np.float32)
    pi = r.integers(0, np_, size=(b, max_pages)).astype(np.int32)
    lengths = r.integers(1, max_pages * page + 1, size=b).astype(np.int32)
    return q, kp, vp, pi, lengths


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_decode_is_the_unsharded_decode_bit_for_bit(shards):
    case = [torch.from_numpy(a) for a in _paged_case(shards)]
    want = paged_attention_reference(*case)
    got = sharded_paged_decode(*case, shards)
    assert torch.equal(got, want)
    # a process's own shard: its heads alone, as one shard
    q, kp, vp, pi, lengths = case
    hq, hk = q.shape[1] // shards, kp.shape[0] // shards
    one = sharded_paged_decode(q[:, -hq:], kp[-hk:], vp[-hk:], pi, lengths,
                               1)
    assert torch.equal(one, want[:, -hq:])


def test_sharded_decode_equals_the_reference_on_a_2_device_mesh():
    import jax
    from jax.sharding import Mesh

    from stochastic_gradient_push_tpu.serve.paged_attention import (
        sharded_paged_decode as jax_sharded)

    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    case = _paged_case(7)
    want = np.asarray(jax_sharded(mesh, *case, use_pallas=False))
    got = sharded_paged_decode(*(torch.from_numpy(a) for a in case), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=MESH_ATOL, rtol=0)


def test_sharded_decode_refuses_kv_heads_the_shards_do_not_divide():
    case = [torch.from_numpy(a) for a in _paged_case(0)]
    with pytest.raises(ValueError, match="kv_heads 4 not divisible by mesh "
                                         "axis 'model' size 3"):
        sharded_paged_decode(*case, 3)


# -- the sharded engine ----------------------------------------------------------


def _drive(engine, prompts, n_new, logits=True):
    """Start every prompt, step them together: tokens per prompt, each
    call's logits (gathered) and every slot's page ids."""
    slots, toks, lgs, pages = [], [], [], []
    for p in prompts:
        slot, tok = engine.start(list(p), len(p) + n_new)
        slots.append(slot)
        toks.append([tok])
        pages.append(tuple(engine.pages.pages_of(slot)))
        if logits:
            lgs.append(engine.last_logits.clone())
    while len(toks[0]) < n_new:
        step = engine.step(slots)
        for i, s in enumerate(slots):
            toks[i].append(step[s])
        if logits:
            lgs.append(engine.last_logits.clone())
        pages.append(tuple(tuple(engine.pages.pages_of(s)) for s in slots))
    for s in slots:
        engine.finish(s)
    engine.pages.assert_quiescent()
    return toks, lgs, pages


PROMPTS = {"one_slot": ([[5, 11, 3]], 6),
           "three_slots_page_crossing": (
               [list(range(1, 14)), [44, 3, 3, 17, 9, 21, 8, 1, 6], [30]],
               5)}


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_sharded_engine_tokens_equal_the_unsharded_and_the_reference(name):
    import jax
    from jax.sharding import Mesh

    from stochastic_gradient_push_tpu.serve.engine import (
        LMEngine as JaxEngine, ServeConfig as JaxServeConfig)
    from stochastic_gradient_push_tpu.serve.load import (
        shard_params_for_decode)

    prompts, n_new = PROMPTS[name]
    params = init_params(TINY, seed=1)
    whole, wl, wp = _drive(LMEngine(params, ServeConfig(**KW),
                                    device="cpu"), prompts, n_new)
    got, gl, gp = _drive(LMEngine(params, ServeConfig(**KW), device="cpu",
                                  shards=2), prompts, n_new)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    ref, _, _ = _drive(JaxEngine(shard_params_for_decode(params, mesh),
                                 JaxServeConfig(**KW), mesh=mesh),
                       prompts, n_new, logits=False)
    assert got == whole == ref
    assert gp == wp
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SHARD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("shards,d_ff,vocab", [(4, 64, 48), (4, 98, 50)],
                         ids=["4", "4-replicated-mlp-and-vocab"])
def test_sharded_engine_at_four_shards_and_the_fallback(shards, d_ff,
                                                        vocab):
    import dataclasses

    params = init_params(dataclasses.replace(TINY, d_ff=d_ff,
                                             vocab_size=vocab), seed=2)
    prompts, n_new = PROMPTS["three_slots_page_crossing"]
    prompts = [[t % vocab for t in p] for p in prompts]
    whole, wl, _ = _drive(LMEngine(params, ServeConfig(**KW), device="cpu"),
                          prompts, n_new)
    engine = LMEngine(params, ServeConfig(**KW), device="cpu",
                      shards=shards)
    got, gl, _ = _drive(engine, prompts, n_new)
    assert got == whole
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SHARD_ATOL,
                                   rtol=0)
    split = engine._lm.layers[0]["mlp_split"]
    assert split == (d_ff % shards == 0)
    assert engine._lm.vocab_split == (vocab % shards == 0)


def test_sharded_engine_keeps_the_whole_models_kv_bytes_and_refusals():
    from stochastic_gradient_push_tpu.serve.engine import (
        LMEngine as JaxEngine, ServeConfig as JaxServeConfig)

    params = init_params(TINY, seed=0)
    two = LMEngine(params, ServeConfig(**KW), device="cpu", shards=2)
    assert (two.kv_bytes_per_token()
            == LMEngine(params, ServeConfig(**KW), device="cpu")
            .kv_bytes_per_token()
            == JaxEngine(params, JaxServeConfig(**KW)).kv_bytes_per_token())
    assert two._kc.shape[1] == 4
    with pytest.raises(ValueError, match="kv_heads 4 not divisible by mesh "
                                         "axis 'model' size 3"):
        LMEngine(params, ServeConfig(**KW), device="cpu", shards=3)


# the engine's forward passes over the whole model before it ran as KV-head
# shards: the oracle that one shard must equal bit for bit
@torch.no_grad()
def _whole_prefill(model, tokens):
    t = tokens.shape[0]
    positions = torch.arange(t, device=tokens.device)
    x = model.embed.weight[tokens][None]
    ks, vs = [], []
    for blk in model.blocks:
        h = blk.ln1(x)
        attn = blk.attn
        q = rope(attn.split(attn.q(h)), positions)
        k = rope(attn.split(attn.k(h)), positions).contiguous()
        v = attn.split(attn.v(h)).contiguous()
        ks.append(k[0])
        vs.append(v[0])
        out = flash_attention(q.contiguous(), k, v, causal=True)
        x = x + attn.o(out.transpose(1, 2).reshape(1, t, -1))
        x = x + blk.mlp(blk.ln2(x))
    logits = model.lm_head(model.ln_f(x))[0].float()
    return logits, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def _whole_decode(model, k_cache, v_cache, tokens, positions, dest_page,
                  dest_off, page_indices, lengths):
    cfg = model.cfg
    bsz = tokens.shape[0]
    heads = torch.arange(cfg.n_heads, device=tokens.device)[:, None]
    where = (heads, dest_page[None], dest_off[None])
    x = model.embed.weight[tokens]
    for i, blk in enumerate(model.blocks):
        h = blk.ln1(x)
        attn = blk.attn
        q = rope_tok(attn.q(h).reshape(bsz, cfg.n_heads, cfg.head_dim),
                     positions)
        k = rope_tok(attn.k(h).reshape(bsz, cfg.n_heads, cfg.head_dim),
                     positions)
        v = attn.v(h).reshape(bsz, cfg.n_heads, cfg.head_dim)
        k_cache[i].index_put_(where, k.transpose(0, 1))
        v_cache[i].index_put_(where, v.transpose(0, 1))
        out = paged_attention_decode(q.contiguous(), k_cache[i], v_cache[i],
                                     page_indices, lengths)
        x = x + attn.o(out.reshape(bsz, cfg.d_model))
        x = x + blk.mlp(blk.ln2(x))
    return model.lm_head(model.ln_f(x)).float()


class _WholeModel:
    """The engine's model slot filled by :func:`_whole_prefill` and
    :func:`_whole_decode` over a ``TransformerLM``."""

    def __init__(self, params, n_heads):
        from stochastic_gradient_push_torch.models.convert import (
            config_from_params, params_from_jax)

        self.model = TransformerLM(config_from_params(params, n_heads))
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval().requires_grad_(False)

    def prefill(self, tokens):
        logits, ks, vs = _whole_prefill(self.model, tokens)
        return [logits], ks, vs

    def decode(self, *args):
        return [_whole_decode(self.model, *args)]

    def greedy(self, parts):
        return torch.argmax(parts[0], -1)

    def gather_logits(self, parts):
        return parts[0]


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_one_shard_is_the_whole_model_engine_bit_for_bit(name):
    prompts, n_new = PROMPTS[name]
    params = init_params(TINY, seed=1)
    got, gl, gp = _drive(LMEngine(params, ServeConfig(**KW), device="cpu"),
                         prompts, n_new)
    whole = LMEngine(params, ServeConfig(**KW), device="cpu")
    whole._lm = _WholeModel(params, KW["n_heads"])
    want, wl, wp = _drive(whole, prompts, n_new)
    assert got == want and gp == wp
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert torch.equal(a, b)


def test_greedy_pairs_break_ties_to_the_lowest_global_index():
    from stochastic_gradient_push_torch.parallel.tp import StackedTp

    engine = LMEngine(init_params(TINY, seed=0), ServeConfig(**KW),
                      device="cpu", tp=StackedTp(2))
    logits = torch.zeros(3, 48)
    logits[0, [3, 30]] = 2.0          # a tie across the shards
    logits[1, [30, 40]] = 1.0         # a tie inside shard 1
    logits[2, 47] = 5.0
    parts = list(logits.chunk(2, dim=-1))
    want = torch.argmax(logits, -1)
    assert torch.equal(engine._lm.greedy(parts), want)
    assert want.tolist() == [3, 30, 47]


# 2 gloo processes, one shard each, beside the stacked engine
_DIST_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.models.convert import init_params
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.parallel import multihost
from stochastic_gradient_push_torch.parallel.collectives import DistTransport
from stochastic_gradient_push_torch.parallel.tp import DistTp
from stochastic_gradient_push_torch.serve.engine import LMEngine, ServeConfig
import test_torch_serve_mesh as t
multihost.initialize_multihost("gloo", "cpu")
params = init_params(t.TINY, seed=1)
engine = LMEngine(params, ServeConfig(**t.KW), device="cpu",
                  tp=DistTp(DistTransport()))
prompts, n_new = t.PROMPTS["three_slots_page_crossing"]
toks, lgs, pages = t._drive(engine, prompts, n_new)
if torch.distributed.get_rank() == 0:
    np.savez(sys.argv[2], *[l.numpy() for l in lgs])
    print("RESULT " + json.dumps([toks, pages]), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def test_two_processes_equal_the_stacked_engine_bit_for_bit(tmp_path):
    out = tmp_path / "logits.npz"
    logs = torchrun(2, lambda r: [sys.executable, "-c", _DIST_CHILD, REPO,
                                  str(out)], timeout=TIMEOUT,
                    PYTHONPATH=f"{REPO}:{REPO}/tests")
    line = next(x for x in logs[0].splitlines() if x.startswith("RESULT "))
    toks, pages = json.loads(line[len("RESULT "):])
    prompts, n_new = PROMPTS["three_slots_page_crossing"]
    want, wl, wp = _drive(LMEngine(init_params(TINY, seed=1),
                                   ServeConfig(**KW), device="cpu",
                                   shards=2), prompts, n_new)
    assert toks == want
    assert pages == json.loads(json.dumps(wp))
    with np.load(out) as got:
        assert len(got.files) == len(wl)
        for i, lg in enumerate(wl):
            assert np.array_equal(got[f"arr_{i}"], lg.numpy()), i


# -- the serve CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    """A world-2 LM run's checkpoint set (d64, 4 heads), tag lm_."""
    from stochastic_gradient_push_torch.run import gossip_lm

    d = tmp_path_factory.mktemp("lm_run")
    gossip_lm.main(["--device", "cpu", "--world_size", "2", "--vocab_size",
                    "64", "--d_model", "64", "--n_layers", "2", "--n_heads",
                    "4", "--d_ff", "128", "--seq_len", "16", "--batch_size",
                    "2", "--num_steps", "2", "--print_freq", "2",
                    "--checkpoint_dir", str(d)])
    return d


def test_cli_serves_a_run_directory_sharded_with_telemetry(lm_run, tmp_path,
                                                           capsys):
    from stochastic_gradient_push_torch.telemetry.registry import (
        EVENT_KINDS)

    art, trace = tmp_path / "a.json", tmp_path / "trace"
    common = [str(lm_run), "--tag", "lm_", "--world", "2", "--n_heads", "4",
              "--device", "cpu", "--requests", "5", "--artifact"]
    assert cli.main(common + [str(art), "--model_shards", "2",
                              "--trace_dir", str(trace)]) == 0
    out = capsys.readouterr().out
    assert ("serve: ingested consensus of world 2 (2 file(s), step 2, 0 "
            "in-flight slot(s) folded)\n") in out
    assert "2 KV-head shards stacked" in out
    assert "kv 1,024 B/token" in out
    doc = json.loads(art.read_text())
    assert cli.ARTIFACT_KEYS <= set(doc["bench"])
    assert doc["bench"]["model_shards"] == 2
    events = [json.loads(x) for x in
              (trace / "events.jsonl").read_text().splitlines()]
    kinds = {e["kind"] for e in events}
    assert {"run_meta", "serve", "request"} <= kinds <= EVENT_KINDS
    meta = next(e for e in events if e["kind"] == "run_meta")["data"]
    assert meta["algorithm"] == "serve" and meta["serve"] is True
    assert meta["model_source"]["world"] == 2
    # the same requests through one shard give the same tokens
    art1 = tmp_path / "b.json"
    assert cli.main(common + [str(art1)]) == 0
    b1 = json.loads(art1.read_text())["bench"]
    for key in ("tokens", "decode_steps", "requests"):
        assert b1[key] == doc["bench"][key], key


def test_ingest_line_is_the_references(lm_run, capsys, monkeypatch):
    import scripts.serve as ref
    from stochastic_gradient_push_tpu.serve import load as jload

    params, meta, info = tload.load_consensus(str(lm_run), "lm_")
    info = tload.IngestInfo(world=info.world, files=info.files, step=7,
                            in_flight_folded=3, ef_forfeited=True,
                            plan=None)
    from stochastic_gradient_push_torch.models.convert import params_to_jax

    tree = params_to_jax(params)
    monkeypatch.setattr(jload, "load_consensus",
                        lambda *a, **k: (tree, meta, info))
    monkeypatch.setattr(tload, "load_consensus",
                        lambda *a, **k: (params, meta, info))
    argv = [str(lm_run), "--n_heads", "4", "--requests", "2", "--artifact",
            "/dev/null"]
    assert ref.main(argv) == 0
    want = capsys.readouterr().out.splitlines()[0]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()[0]
    assert got == want == ("serve: ingested consensus of world 2 (2 "
                           "file(s), step 7, 3 in-flight slot(s) folded, "
                           "EF residual forfeited)")


@pytest.mark.parametrize("model", ["tiny_cnn", "tiny_mlp"])
def test_digest_seed_equals_the_references(model):
    import scripts.serve as ref
    from stochastic_gradient_push_torch.models.convert import (
        init_model_params, reference_layout)
    from stochastic_gradient_push_torch.train.step import make_model

    m = make_model(model, num_classes=10)
    params, _ = init_model_params(m, seed=3)
    layout = reference_layout(m)
    flat = {}
    for n in layout.order:       # the reference's tree: sorted, its layout
        a = params[n].numpy()
        perm = layout.perm(n)
        flat[n] = a if perm is None else np.transpose(a, perm)
    args = type("A", (), dict(n_heads=None, page_size=4, num_pages=8,
                              max_seqs=2, max_pages_per_seq=4,
                              model_shards=1))()
    engine, vocab = ref._build_engine(flat, None, args)
    assert vocab == 256 and cli.reference_digest(params) == engine.seed


def test_cli_falls_back_to_the_synthetic_engine(tmp_path, capsys):
    from stochastic_gradient_push_torch.run import gossip_sgd

    gossip_sgd.main(["--device", "cpu", "--dataset", "synthetic", "--model",
                     "tiny_mlp", "--image_size", "8", "--num_classes", "4",
                     "--batch_size", "2", "--world_size", "2",
                     "--num_epochs", "1",
                     "--num_iterations_per_training_epoch", "2",
                     "--checkpoint_dir", str(tmp_path / "run")])
    params, _, _ = tload.load_consensus(str(tmp_path / "run"))
    art = tmp_path / "a.json"
    capsys.readouterr()
    assert cli.main([str(tmp_path / "run"), "--requests", "6", "--device",
                     "cpu", "--artifact", str(art)]) == 0
    out = capsys.readouterr().out
    seed = cli.reference_digest(params)
    assert f"synthetic engine (seed {seed})" in out
    assert "serve: 6 request(s)" in out and "kernel launches" not in out


@pytest.mark.parametrize("argv,code,match", [
    (["--tag", "lm_", "--device", "cpu"], 2, "--n_heads is required"),
    (["--tag", "lm_", "--n_heads", "4", "--model_shards", "3", "--device",
      "cpu"], 2, "kv_heads 4 not divisible by mesh axis 'model' size 3"),
    (["--tag", "nope_", "--n_heads", "4", "--device", "cpu"], 2,
     "no nope_checkpoint_r"),
    (["--tag", "lm_", "--world", "8", "--n_heads", "4", "--device", "cpu"],
     2, ""),
], ids=["no_n_heads", "shards_not_dividing_heads", "empty_dir",
        "no_such_world"])
def test_cli_exit_codes(lm_run, argv, code, match, tmp_path, capsys):
    assert cli.main([str(lm_run), *argv, "--artifact",
                     str(tmp_path / "a.json")]) == code
    assert match in capsys.readouterr().err


def test_cli_needs_exactly_one_source(lm_run):
    with pytest.raises(SystemExit) as e:
        cli.main(["--n_heads", "4"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main([str(lm_run), "--init_seed", "0", "--n_heads", "4"])
    assert e.value.code == 2


def test_selftest_passes_and_a_broken_decode_fails_it(capsys, monkeypatch):
    assert cli.main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "serve selftest: OK"
    assert "bit-equal to reshard_state collapse" in out
    from stochastic_gradient_push_torch.serve import paged_attention

    real = paged_attention.sharded_paged_decode
    monkeypatch.setattr(paged_attention, "sharded_paged_decode",
                        lambda *a, **k: real(*a, **k) + 1.0)
    assert cli.main(["--selftest", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == \
        "serve selftest: FAILED"


def test_cli_under_torchrun_prints_once(lm_run, tmp_path):
    art = tmp_path / "a.json"
    argv = [sys.executable, "-m", "stochastic_gradient_push_torch.serve.cli",
            str(lm_run), "--tag", "lm_", "--n_heads", "4", "--model_shards",
            "2", "--requests", "4", "--device", "cpu", "--artifact",
            str(art)]
    logs = torchrun(2, lambda r: argv, timeout=TIMEOUT, PYTHONPATH=REPO)
    assert "one a process (shard 0)" in logs[0]
    assert "serve: 4 request(s)" in logs[0]
    assert "serve: 4 request(s)" not in logs[1]
    assert "(process 1)" in logs[1]
    assert json.loads(art.read_text())["bench"]["requests"] == 4

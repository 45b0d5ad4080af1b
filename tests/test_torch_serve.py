"""Port parity: the serving path of ``stochastic_gradient_push_torch``
against the JAX package's, on the CPU (the kernels' plain twins).

* the copied ``PageTable`` / ``ContinuousBatcher`` keep the behaviours
  ``tests/test_serve.py`` pins for the originals;
* ``params_from_jax`` / ``init_params`` keep the flax tree layout;
* the engine's greedy tokens equal the JAX ``LMEngine``'s token for token,
  and its prefill/decode logits match JAX at atol 1e-4 (fp32, different
  summation orders);
* ``run_bench`` on the same ``synthetic_requests`` seed yields the same
  completions in both packages; the CLI prints the same lines and writes
  the same artifact keys.
"""

import json

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.device import (
    DeviceUnavailableError, resolve_device)
from stochastic_gradient_push_torch.models.convert import (
    config_from_params, flatten_tree, init_params, params_from_jax,
    unflatten_tree)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig, TransformerLM)
from stochastic_gradient_push_torch.serve import bench as tbench
from stochastic_gradient_push_torch.serve.engine import (
    LMEngine, ServeConfig, pad_len)
from stochastic_gradient_push_torch.serve.pages import (
    PageCapacityError, PageTable, pages_for)
from stochastic_gradient_push_torch.serve.scheduler import (
    AdmissionError, ContinuousBatcher, Request)

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4

# -- copied page table: the behaviours tests/test_serve.py pins ---------------


def _pages_for_is_ceil_div():
    assert [pages_for(n, 8) for n in (1, 8, 9, 0)] == [1, 1, 2, 0]


def _open_reserves_full_budget_up_front():
    t = PageTable(num_pages=8, page_size=4, max_seqs=4)
    slot = t.open(budget_tokens=10)
    assert t.reserved_pages == 3 and t.used_pages == 0
    assert t.available_pages == 5
    t.append(slot, 10)
    assert t.used_pages == 3 and t.reserved_pages == 0
    t.close(slot)
    assert t.free_pages == 8


def _pages_hand_out_ascending_and_recycle():
    t = PageTable(num_pages=4, page_size=2, max_seqs=4)
    a = t.open(4)
    t.append(a, 4)
    assert t.pages_of(a) == (0, 1)
    b = t.open(4)
    t.append(b, 4)
    assert t.pages_of(b) == (2, 3)
    t.close(a)
    c = t.open(3)
    t.append(c, 3)
    assert set(t.pages_of(c)) <= {0, 1}
    t.close(b)
    t.close(c)
    t.assert_quiescent()


def _capacity_errors_are_typed():
    t = PageTable(num_pages=2, page_size=4, max_seqs=1)
    with pytest.raises(PageCapacityError):
        t.open(9)
    slot = t.open(8)
    with pytest.raises(PageCapacityError):
        t.open(1)
    t.append(slot, 8)
    with pytest.raises(PageCapacityError):
        t.append(slot, 1)
    t.close(slot)


def _reservation_blocks_other_admissions():
    t = PageTable(num_pages=4, page_size=4, max_seqs=4)
    s = t.open(16)
    t.append(s, 2)
    assert t.used_pages == 1 and t.available_pages == 0
    assert not t.can_fit(1)
    with pytest.raises(PageCapacityError):
        t.open(1)
    t.close(s)
    assert t.can_fit(16)


def _last_position_and_page_index_array():
    t = PageTable(num_pages=4, page_size=4, max_seqs=2)
    s = t.open(10)
    t.append(s, 5)
    assert t.length(s) == 5
    assert t.last_position(s) == (t.pages_of(s)[1], 0)
    rows = t.page_index_array([s], max_pages=3)
    assert rows.shape == (1, 3) and rows.dtype == np.int32
    assert tuple(rows[0, :2]) == t.pages_of(s)
    t.close(s)


def _quiescence_names_leaks():
    t = PageTable(num_pages=4, page_size=4, max_seqs=2)
    t.open(4)
    with pytest.raises(AssertionError, match="live sequences"):
        t.assert_quiescent()


@pytest.mark.parametrize("case", [
    _pages_for_is_ceil_div, _open_reserves_full_budget_up_front,
    _pages_hand_out_ascending_and_recycle, _capacity_errors_are_typed,
    _reservation_blocks_other_admissions,
    _last_position_and_page_index_array, _quiescence_names_leaks,
], ids=lambda f: f.__name__.lstrip("_"))
def test_page_table_copy(case):
    case()


def test_page_table_copy_tracks_the_original_op_for_op():
    from stochastic_gradient_push_tpu.serve.pages import (
        PageCapacityError as JaxCapacityError, PageTable as JaxPageTable)

    r = np.random.default_rng(0)
    tables = [PageTable(24, 4, 5), JaxPageTable(24, 4, 5)]
    for _ in range(400):
        op, budget, pick, grow = (int(r.integers(3)), int(r.integers(1, 30)),
                                  int(r.integers(5)), int(r.integers(1, 6)))
        outs = []
        for t in tables:
            try:
                if op == 0:
                    outs.append(("open", t.open(budget)))
                elif t.slots and op == 1:
                    s = t.slots[pick % len(t.slots)]
                    t.append(s, grow)
                    outs.append(("append", s, t.pages_of(s)))
                elif t.slots:
                    s = t.slots[pick % len(t.slots)]
                    t.close(s)
                    outs.append(("close", s))
            except (PageCapacityError, JaxCapacityError) as e:
                outs.append(type(e).__name__)   # same typed backpressure
        assert len(outs) in (0, 2) and outs[:1] == outs[1:]
        assert tables[0].free_pages == tables[1].free_pages
        assert tables[0].available_pages == tables[1].available_pages
        assert tables[0].slots == tables[1].slots


# -- copied batcher, over a deterministic stand-in engine ---------------------


class _ArithmeticEngine:
    """The slot/page discipline of an engine with arithmetic tokens."""

    def __init__(self, num_pages=32, max_seqs=4, page_size=4,
                 max_pages_per_seq=8):
        self.config = ServeConfig(n_heads=1, page_size=page_size,
                                  num_pages=num_pages, max_seqs=max_seqs,
                                  max_pages_per_seq=max_pages_per_seq)
        self.pages = PageTable(num_pages, page_size, max_seqs)
        self._last = {}

    def can_admit(self, budget):
        return (budget <= self.config.max_tokens_per_seq
                and self.pages.can_fit(budget))

    def required_pages(self, budget):
        return pages_for(budget, self.config.page_size)

    def start(self, prompt, budget):
        slot = self.pages.open(budget)
        self.pages.append(slot, len(prompt))
        self._last[slot] = (sum(prompt) + 31 * len(prompt)) % 256
        return slot, self._last[slot]

    def step(self, slots):
        out = {}
        for slot in slots:
            self.pages.append(slot, 1)
            self._last[slot] = (self._last[slot] * 31 + slot + 7) % 256
            out[slot] = self._last[slot]
        return out

    def finish(self, slot):
        self._last.pop(slot, None)
        self.pages.close(slot)


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, kind, data, severity="info"):
        self.events.append((kind, data, severity))

    def by_kind(self, kind):
        return [e for e in self.events if e[0] == kind]


def _no_slot_leak_over_200_requests():
    engine = _ArithmeticEngine()
    requests = tbench.synthetic_requests(200, seed=3)
    metrics, completions = tbench.run_bench(engine, requests)
    assert metrics["requests"] == 200 == len(completions)
    engine.pages.assert_quiescent()
    by_rid = {r.rid: r for r in requests}
    for c in completions:
        assert len(c.tokens) == by_rid[c.rid].max_new_tokens


def _permanent_rejection_is_typed_and_counted():
    events = _Events()
    batcher = ContinuousBatcher(_ArithmeticEngine(max_pages_per_seq=2),
                                registry=events)
    with pytest.raises(AdmissionError):
        batcher.submit(Request(rid=0, prompt=(1,) * 10, max_new_tokens=5))
    assert batcher.rejected == 1 and batcher.pending == 0
    [(_, data, severity)] = events.by_kind("serve")
    assert data["phase"] == "reject" and severity == "warning"


def _backpressure_queues_fifo_and_drains():
    events = _Events()
    batcher = ContinuousBatcher(
        _ArithmeticEngine(num_pages=4, max_seqs=1, max_pages_per_seq=4),
        registry=events)
    for rid in range(6):
        batcher.submit(Request(rid=rid, prompt=(1, 2, 3), max_new_tokens=3))
    completions = batcher.drain()
    assert [c.rid for c in completions] == list(range(6))
    assert len(events.by_kind("request")) == 6
    assert batcher.peak_occupancy > 0


def _max_new_one_completes_at_prefill():
    batcher = ContinuousBatcher(_ArithmeticEngine())
    batcher.submit(Request(rid=7, prompt=(4, 5), max_new_tokens=1))
    [done] = batcher.step()
    assert done.rid == 7 and len(done.tokens) == 1
    batcher.engine.pages.assert_quiescent()


@pytest.mark.parametrize("case", [
    _no_slot_leak_over_200_requests,
    _permanent_rejection_is_typed_and_counted,
    _backpressure_queues_fifo_and_drains, _max_new_one_completes_at_prefill,
], ids=lambda f: f.__name__.lstrip("_"))
def test_batcher_copy(case):
    case()


def test_synthetic_streams_equal_the_reference():
    from stochastic_gradient_push_tpu.serve import bench as jbench

    assert (tbench.synthetic_requests(30, seed=5, prompt_tokens=(3, 40))
            == [Request(r.rid, r.prompt, r.max_new_tokens) for r in
                jbench.synthetic_requests(30, seed=5,
                                          prompt_tokens=(3, 40))])
    assert (tbench.poisson_arrivals(20, 7.5, seed=2)
            == jbench.poisson_arrivals(20, 7.5, seed=2))


# -- parameters ----------------------------------------------------------------


def _tiny_lm(seed=0):
    import jax

    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JaxConfig, TransformerLM as JaxLM)

    model = JaxLM(JaxConfig(vocab_size=48, d_model=16, n_layers=2,
                            n_heads=2, d_ff=32, max_len=32,
                            attn_impl="full"))
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, 8), np.int32))
    return model, jax.tree.map(np.asarray, variables["params"])


TINY = TransformerConfig(vocab_size=48, d_model=16, n_layers=2, n_heads=2,
                         d_ff=32)


def test_init_params_has_the_flax_layout():
    _, jax_params = _tiny_lm()
    mine = init_params(TINY, seed=0)
    want = {k: v.shape for k, v in flatten_tree(jax_params).items()}
    assert {k: v.shape for k, v in flatten_tree(mine).items()} == want
    assert all(v.dtype == np.float32 for v in flatten_tree(mine).values())
    assert config_from_params(mine, 2) == TINY


def test_init_params_distributions():
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_layers=1,
                            n_heads=1, d_ff=256)
    p = init_params(cfg, seed=1)
    up = p["block_0"]["up"]["kernel"]
    assert np.all(np.abs(up) < 2 * 64 ** -0.5 / 0.87962566103423978)
    assert abs(up.std() - 64 ** -0.5) < 0.01
    assert abs(p["embed"]["embedding"].std() - 0.02) < 0.002
    assert np.all(p["block_0"]["up"]["bias"] == 0)
    assert np.all(p["ln_f"]["scale"] == 1)
    again = init_params(cfg, seed=1)
    assert np.array_equal(again["block_0"]["up"]["kernel"], up)


def test_params_from_jax_transposes_kernels_once():
    _, jax_params = _tiny_lm()
    state = params_from_jax(jax_params)
    np.testing.assert_array_equal(
        state["block_0.attn.q.weight"].numpy(),
        jax_params["block_0"]["attn"]["q"]["kernel"].T)
    np.testing.assert_array_equal(state["embed.weight"].numpy(),
                                  jax_params["embed"]["embedding"])
    model = TransformerLM(TINY)
    model.load_state_dict(state)      # every name matches, none missing
    flat = flatten_tree(jax_params)
    assert flatten_tree(unflatten_tree(flat)).keys() == flat.keys()


def test_dense_model_matches_jax_logits():
    model, params = _tiny_lm()
    tokens = np.array([[5, 11, 3, 7, 1, 9, 40, 2, 0, 13]], np.int32)
    want = np.asarray(model.apply({"params": params}, tokens))
    mine = TransformerLM(TINY)
    mine.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = mine(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


# -- engine vs the JAX engine ----------------------------------------------------

KW = dict(n_heads=2, page_size=4, num_pages=16, max_seqs=2,
          max_pages_per_seq=4)


def _drive(engine, prompts, n_new):
    """Start every prompt, step them together; return tokens per prompt
    and (for the port) the logits each call produced per prompt."""
    slots, toks, logits = [], [], []
    for p in prompts:
        slot, tok = engine.start(list(p), len(p) + n_new)
        slots.append(slot)
        toks.append([tok])
        logits.append([getattr(engine, "last_logits", None)])
    while len(toks[0]) < n_new:
        step = engine.step(slots)
        for i, s in enumerate(slots):
            toks[i].append(step[s])
            lg = getattr(engine, "last_logits", None)
            logits[i].append(None if lg is None else lg[s])
    for s in slots:
        engine.finish(s)
    engine.pages.assert_quiescent()
    return toks, logits


@pytest.mark.parametrize("seed,prompts,n_new", [
    (0, [[5, 11, 3]], 5),                 # tests/test_serve.py:291
    (1, [[7, 2, 9, 4], [30, 1]], 4),      # tests/test_serve.py:310
], ids=["one_slot", "two_concurrent_slots"])
def test_engine_greedy_tokens_equal_jax_engine(seed, prompts, n_new):
    from stochastic_gradient_push_tpu.serve.engine import (
        LMEngine as JaxEngine, ServeConfig as JaxServeConfig)

    _, params = _tiny_lm(seed)
    want, _ = _drive(JaxEngine(params, JaxServeConfig(**KW)), prompts, n_new)
    got, _ = _drive(LMEngine(params, ServeConfig(**KW), device="cpu"),
                    prompts, n_new)
    assert got == want


@pytest.mark.parametrize("seed,prompts,n_new", [
    (0, [[5, 11, 3]], 5),
    (1, [[7, 2, 9, 4], [30, 1]], 4),
    (2, [list(range(1, 14)), [44, 3, 3, 17, 9, 21, 8, 1, 6]], 3),
], ids=["one_slot", "two_concurrent_slots", "page_crossing_prompts"])
def test_engine_logits_match_jax(seed, prompts, n_new):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.serve.engine import _prefill_fn

    model, params = _tiny_lm(seed)
    toks, logits = _drive(LMEngine(params, ServeConfig(**KW), device="cpu"),
                          prompts, n_new)
    for p, tk, lg in zip(prompts, toks, logits):
        t = len(p)
        padded = np.zeros(pad_len(t), np.int32)
        padded[:t] = p
        jl, _, _ = _prefill_fn(params, jnp.asarray(padded), n_heads=2)
        np.testing.assert_allclose(lg[0].numpy(), np.asarray(jl)[:t],
                                   atol=LOGIT_ATOL, rtol=0)
        seq = np.asarray([p + tk[:-1]], np.int32)
        dense = np.asarray(model.apply({"params": params}, seq))[0]
        for j, step_logits in enumerate(lg[1:]):
            np.testing.assert_allclose(step_logits.numpy(), dense[t + j],
                                       atol=LOGIT_ATOL, rtol=0)


def test_kv_bytes_per_token_equals_jax():
    from stochastic_gradient_push_tpu.serve.engine import (
        LMEngine as JaxEngine, ServeConfig as JaxServeConfig)

    _, params = _tiny_lm()
    mine = LMEngine(params, ServeConfig(n_heads=2), device="cpu")
    assert (mine.kv_bytes_per_token()
            == JaxEngine(params, JaxServeConfig(n_heads=2))
            .kv_bytes_per_token() == 2 * 2 * 2 * 8 * 4)


def test_run_bench_completions_equal_jax():
    from stochastic_gradient_push_tpu.serve import bench as jbench
    from stochastic_gradient_push_tpu.serve.engine import (
        LMEngine as JaxEngine, ServeConfig as JaxServeConfig)

    _, params = _tiny_lm(3)
    kw = dict(n_heads=2, page_size=4, num_pages=24, max_seqs=3,
              max_pages_per_seq=5)
    stream = dict(seed=4, vocab=48, prompt_tokens=(2, 10),
                  new_tokens=(1, 6))
    jm, jc = jbench.run_bench(JaxEngine(params, JaxServeConfig(**kw)),
                              jbench.synthetic_requests(12, **stream))
    tm, tc = tbench.run_bench(LMEngine(params, ServeConfig(**kw),
                                       device="cpu"),
                              tbench.synthetic_requests(12, **stream))
    assert ({c.rid: c.tokens for c in tc}
            == {c.rid: c.tokens for c in jc})
    for key in ("requests", "tokens", "decode_steps", "kv_bytes_per_token",
                "page_occupancy_peak", "admission_rejections"):
        assert tm[key] == jm[key], key


# -- device rule and CLI ---------------------------------------------------------


def test_cuda_by_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        resolve_device()
    with pytest.raises(DeviceUnavailableError):
        LMEngine(init_params(TINY, 0), ServeConfig(n_heads=2))
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_serves_and_writes_the_artifact(tmp_path, capsys):
    from stochastic_gradient_push_torch.serve import cli

    _, params = _tiny_lm()
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_tree(params))
    art = tmp_path / "bench_serve.json"
    common = ["--n_heads", "2", "--device", "cpu", "--requests", "6",
              "--artifact", str(art)]
    assert cli.main(["--params_npz", str(npz), *common]) == 0
    out = capsys.readouterr().out
    assert "serve: 6 request(s)" in out
    assert "0 admission rejection(s), kv 256 B/token" in out
    doc = json.loads(art.read_text())
    assert set(doc) == {"bench", "trace"}
    assert cli.ARTIFACT_KEYS <= set(doc["bench"])
    assert doc["bench"]["requests"] == 6
    assert cli.main(["--init_seed", "0", "--d_model", "16", "--n_layers",
                     "1", "--d_ff", "32", "--vocab_size", "40",
                     *common]) == 0
    assert cli.main(["--init_seed", "0", "--d_model", "15",
                     *common]) == 2

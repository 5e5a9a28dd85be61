"""The port's rows KV layout (tpu_dra_torch/parallel/serve.py with
``kv_layout="rows"``, its row-backed prefix cache in prefixcache.py and
the row copies of decode.py) against the reference's rows engine
(tpu_dra/parallel/serve.py) on the reference's weights, dense and MoE.

- The two engines serve one stream ticked together, greedy and sampled,
  continuous and fused ticks: ``device_steps``/``wasted_steps``, queue
  and occupancy equal after every tick; tokens equal up to the first
  divergence, which must be a near-tie of the reference's (perturbed)
  logits; logprobs before it within ``2 * 2**-6 * max|logit|``
  (test_torch_sample's rules: the port's logits are the reference's
  within 2 bf16 ulps, not bitwise).  The reference's logits are walked
  along the engine's own path (`test_torch_generate.walk_logits`:
  prefill, then one-token steps), which for an MoE model is the one
  that routes as the engine does.  After every tick the rows whose
  tokens agree hold the same K/V in every position (the whole-row
  insert: prompt, pads and zeros) within that tolerance.
- The rows prefix cache: ``prefix_stats`` and ``prefix_reused`` equal
  every tick, tokens as above; cache on and off give the same tokens.
- Warm restart on rows against the reference's.
- Every constructor refusal of the reference's rows layout, message for
  message, and the layout defaults.
- chip_smoke.py's rows-and-MoE phase at a tiny width: its counts, which
  the chip run must show.

MoE tests assert the smallest router margin above the tie threshold
(`test_torch_moe.router_margins`)."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from test_torch_generate import walk_logits
from test_torch_moe import moe_configs, router_margins
from test_torch_prefix import reference_prefix_stats
from test_torch_sample import assert_sequences_match
from tpu_dra.parallel import quant as jq
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import burnin as tburnin
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import quant as tq
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)

SPEC = dict(slots=3, prompt_slots=8, max_new_cap=6, kv_layout="rows")
SAMPLING = {"greedy": dict(), "sampled": dict(temperature=0.8, top_k=20, top_p=0.9)}
SCHEDULES = {"continuous": dict(scheduling="continuous", steps_per_tick=2),
             "tick": dict(scheduling="tick", steps_per_tick=3)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg, tcfg) in {"dense": CONFIGS["dense"], "moe": moe_configs()}.items():
        out[name] = (jcfg, tcfg, *both_params(jcfg))
    return out


def margins(name):
    return router_margins() if name == "moe" else contextlib.nullcontext()


def _stream(vocab, n=7, seed=3, prompt_slots=8, max_new=6):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, vocab, rng.randint(1, prompt_slots + 1))],
             int(rng.randint(1, max_new + 1)), int(rng.randint(-2 ** 31, 2 ** 31)))
            for _ in range(n)]


def _submit(eng, reqs):
    return [eng.submit(p, b, seed=s) for p, b, s in reqs]


def lockstep(jeng, teng, reqs, between=None):
    """Both engines ticked together until they drain, the step counters,
    queue and occupancy equal after every tick (``between(jeng, teng,
    tick)`` runs there too).  Returns both sides' requests in submit
    order."""
    jids, tids = _submit(jeng, reqs), _submit(teng, reqs)
    tick = 0
    while jeng.pending or teng.pending:
        jeng.tick()
        teng.tick()
        assert (teng.device_steps, teng.wasted_steps) == (jeng.device_steps, jeng.wasted_steps)
        assert (teng.queue_depth, teng.occupancy) == (jeng.queue_depth, jeng.occupancy)
        if between is not None:
            between(jeng, teng, tick)
        tick += 1
    return [jeng.request(i) for i in jids], [teng.request(i) for i in tids]


def assert_tokens_match(jcfg, jparams, reqs, want, got, kw, logprobs=False):
    """Tokens (and logprobs) against the reference's, walked along the
    engine's path; the sampled key is fold_in(PRNGKey(seed), position)."""
    T = kw.get("temperature", 0.0)

    def rows(i):
        return walk_logits(jcfg, jparams, reqs[i][0], list(want[i].tokens), kw.get("kv_int8", False))

    def gumbel(i, j):
        k = jax.random.fold_in(jax.random.PRNGKey(reqs[i][2]), len(reqs[i][0]) + j)
        return np.asarray(jax.random.gumbel(k, (jcfg.vocab,)))

    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert_sequences_match([r.tokens for r in got], [list(r.tokens) for r in want], rows, gumbel,
                           T, kw.get("top_k"), kw.get("top_p"),
                           [r.logprobs for r in got] if logprobs else None,
                           [r.logprobs for r in want] if logprobs else None)


def assert_rows_close(jeng, teng, tick=None):
    """Every row whose request has generated the same tokens on both
    sides holds the same K/V in every position (its prompt, its pads and
    the zeros the whole-row insert wrote past them), within 2 bf16 ulps
    of the row's largest magnitude; an int8 cache is compared
    dequantized (test_torch_decode's rule: a value may move one step of
    its scale where a bf16 input moved an ulp)."""
    for row, (j, t) in enumerate(zip(jeng._row_req, teng._row_req)):
        if j is None or t is None or list(j.tokens) != t.tokens:
            continue
        for name in ("k", "v"):
            want = np.asarray(jq.dequantize(jeng._cache[name]), np.float32)[:, row]
            got = tq.dequantize(teng._cache[name]).float()[:, row].numpy()
            np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2 ** -6 * np.abs(want).max())


class TestRowsParity:
    @pytest.mark.parametrize("sched", sorted(SCHEDULES))
    @pytest.mark.parametrize("sampling", sorted(SAMPLING))
    @pytest.mark.parametrize("name", ["dense", "moe"])
    def test_matches_reference_tick_by_tick(self, models, name, sampling, sched):
        jcfg, tcfg, jparams, tparams = models[name]
        kw = {**SAMPLING[sampling], **SCHEDULES[sched], "with_logprobs": True}
        reqs = _stream(jcfg.vocab)
        jeng = JaxEngine(jparams, jcfg, **SPEC, **kw)
        teng = ServeEngine(tparams, tcfg, device="cpu", **SPEC, **kw)
        with margins(name):
            want, got = lockstep(jeng, teng, reqs, between=assert_rows_close)
        assert (teng.wasted_steps > 0) == (sched == "tick")
        assert all(len(r.logprobs) == len(r.tokens) and all(lp <= 0 for lp in r.logprobs)
                   for r in got)
        assert_tokens_match(jcfg, jparams, reqs, want, got, kw, logprobs=True)
        assert teng.kv_layout == "rows" and teng.attn_backend == "gather"
        assert teng.kv_block_stats == {} == jeng.kv_block_stats

    def test_int8_moe_matches_reference(self, models):
        """Int8 expert weights (the router kept f32) and an int8 row cache."""
        jcfg, tcfg = moe_configs()
        jparams, tparams = both_params(jcfg, quantized=True)
        assert tparams["layers"]["router"].dtype == torch.float32
        kw = dict(kv_int8=True)
        reqs = _stream(jcfg.vocab, n=5, seed=8)
        jeng = JaxEngine(jparams, jcfg, **SPEC, **kw)
        teng = ServeEngine(tparams, tcfg, device="cpu", **SPEC, **kw)
        with router_margins():
            want, got = lockstep(jeng, teng, reqs, between=assert_rows_close)
        assert isinstance(teng._cache["k"], dict)
        assert_tokens_match(jcfg, jparams, reqs, want, got, kw)

    def test_rows_walking_past_the_context_in_a_fused_tick(self, models):
        """Fused ticks of 12 on a context of 32 (prompt_slots 16 +
        max_new_cap 16): the longest requests finish early in a call and
        their rows step on to position 39.  The port clamps them to the
        row's last slot (no index leaves its range); the rows stay live
        for the queued requests that take them next, whose tokens still
        match the reference's."""
        jcfg, tcfg, jparams, tparams = models["dense"]
        spec = dict(SPEC, slots=2, prompt_slots=16, max_new_cap=16, scheduling="tick",
                    steps_per_tick=12)
        rng = np.random.RandomState(9)
        reqs = [([int(t) for t in rng.randint(0, jcfg.vocab, 16)], 16, i) for i in range(2)]
        reqs += [([int(t) for t in rng.randint(0, jcfg.vocab, 5)], 6, 2 + i) for i in range(2)]
        jeng = JaxEngine(jparams, jcfg, **spec)
        teng = ServeEngine(tparams, tcfg, device="cpu", **spec)
        walked = []
        real = td._step_rows

        def spy(params, tok, cache, pos, config, rows=None):
            walked.append(int(pos.max()))
            return real(params, tok, cache, pos, config, rows)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("tpu_dra_torch.parallel.serve._step_rows", spy)
            want, got = lockstep(jeng, teng, reqs)
        assert max(walked) >= tcfg.seq and teng.wasted_steps > 0
        assert_tokens_match(jcfg, jparams, reqs, want, got, {})

    def test_decode_step_rows_clamps_past_the_context(self, models):
        """A position past the context writes the row's last slot and
        nothing else; rows inside the context are as without it."""
        _, tcfg, _, tparams = models["dense"]
        cache = td.init_cache(tcfg, 2, device="cpu")
        tok = torch.tensor([3, 4])
        logits, cache = td.decode_step_rows(tparams, tok, cache, torch.tensor([5, 40]), tcfg)
        alone, ref = td.decode_step_rows(tparams, tok[:1], td.init_cache(tcfg, 1, device="cpu"),
                                         torch.tensor([5]), tcfg)
        assert torch.equal(logits[0], alone[0])
        assert torch.equal(cache["k"][:, 0], ref["k"][:, 0])
        written = cache["k"][:, 1].abs().sum(dim=(0, 2, 3)) > 0  # (T,)
        assert written.nonzero().flatten().tolist() == [tcfg.seq - 1]


class TestRowsPrefixCache:
    def _shared(self, vocab, n=7, seed=4):
        rng = np.random.RandomState(seed)
        shared = [int(t) for t in rng.randint(0, vocab, 5)]
        return [(shared + [int(t) for t in rng.randint(0, vocab, rng.randint(0, 4))],
                 int(rng.randint(1, 6)), i) for i in range(n)]

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_matches_reference_tick_by_tick(self, models, int8):
        jcfg, tcfg, jparams, tparams = models["dense"]
        if int8:
            jparams, tparams = both_params(jcfg, quantized=True)
        kw = dict(prefix_cache_slots=2, prefix_window=2, kv_int8=int8)
        reqs = self._shared(jcfg.vocab)
        jeng = JaxEngine(jparams, jcfg, **SPEC, **kw)
        teng = ServeEngine(tparams, tcfg, device="cpu", **SPEC, **kw)

        def stats(jeng, teng, tick):
            assert reference_prefix_stats(teng.prefix_stats) == jeng.prefix_stats

        want, got = lockstep(jeng, teng, reqs, between=stats)
        assert [r.prefix_reused for r in got] == [r.prefix_reused for r in want]
        assert sum(r.prefix_reused > 0 for r in got) >= 3
        assert teng.prefix_stats["evictions"] > 0 or teng.prefix_stats["resident"] <= 2
        assert_tokens_match(jcfg, jparams, reqs, want, got, kw)

    def test_cache_on_equals_cache_off(self, models):
        jcfg, tcfg, jparams, tparams = models["dense"]
        reqs = self._shared(jcfg.vocab, seed=5)
        out = {}
        for slots in (0, 3):
            eng = ServeEngine(tparams, tcfg, device="cpu", prefix_cache_slots=slots,
                              prefix_window=2, **SPEC)
            ids = _submit(eng, reqs)
            eng.run()
            out[slots] = [eng.request(i) for i in ids]
        assert sum(r.prefix_reused for r in out[3]) > 0
        assert_tokens_match(jcfg, jparams, reqs, out[0], out[3], {})

    def test_pins_released_and_pool_rows_reused(self, models):
        _, tcfg, _, tparams = models["dense"]
        eng = ServeEngine(tparams, tcfg, device="cpu", prefix_cache_slots=2, prefix_window=2,
                          **SPEC)
        _submit(eng, self._shared(tcfg.vocab, n=9, seed=6))
        eng.run()
        assert all(not pins for pins in eng._row_pins)
        assert all(e.refcount == 0 for e in eng._prefix._entries)
        assert eng.prefix_stats["resident"] <= 2


class TestRowsWarmRestart:
    def test_matches_reference(self, models):
        """A cold rows engine's index warm-starts a fresh one, on both
        sides: the warmed count and ``prefix_stats`` equal, every request
        of the warm engine's first wave reuses the shared prefix, and the
        warm engine's tokens equal the cold one's."""
        jcfg, tcfg, jparams, tparams = models["dense"]
        kw = dict(prefix_cache_slots=2, prefix_window=2)
        reqs = TestRowsPrefixCache()._shared(jcfg.vocab, n=5, seed=7)
        cold = ServeEngine(tparams, tcfg, device="cpu", **SPEC, **kw)
        ids = _submit(cold, reqs)
        cold.run()
        index = cold.export_prefix_index()
        cold.close()
        assert cold._cache is None and cold.export_prefix_index() == index
        jcold = JaxEngine(jparams, jcfg, **SPEC, **kw)
        _submit(jcold, reqs)
        jcold.run()
        assert index == jcold.export_prefix_index()
        jwarm = JaxEngine(jparams, jcfg, **SPEC, **kw)
        twarm = ServeEngine(tparams, tcfg, device="cpu", **SPEC, **kw)
        assert twarm.warm_start(index) == jwarm.warm_start(index) > 0
        assert reference_prefix_stats(twarm.prefix_stats) == jwarm.prefix_stats

        def stats(jeng, teng, tick):
            assert reference_prefix_stats(teng.prefix_stats) == jeng.prefix_stats

        want, got = lockstep(jwarm, twarm, reqs, between=stats)
        assert all(r.prefix_reused >= 4 for r in got[:SPEC["slots"]])
        assert [r.prefix_reused for r in got] == [r.prefix_reused for r in want]
        assert [r.tokens for r in got] == [cold.request(i).tokens for i in ids]
        assert_tokens_match(jcfg, jparams, reqs, want, got, {})


class TestRowsRules:
    """The constructor refusals of the reference's rows layout, message
    for message, and the layout defaults."""

    @staticmethod
    def _messages(models, name, exc=ValueError, **kw):
        jcfg, tcfg, jparams, tparams = models[name]
        with pytest.raises(exc) as want:
            JaxEngine(jparams, jcfg, slots=2, prompt_slots=8, max_new_cap=4, **kw)
        with pytest.raises(exc) as got:
            ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=4, device="cpu", **kw)
        return str(got.value), str(want.value)

    @pytest.mark.parametrize("name,kw", [
        ("dense", dict(kv_layout="ragged")),
        ("dense", dict(kv_layout="rows", tier="prefill")),
        ("dense", dict(kv_layout="rows", tier="decode")),
        ("moe", dict(kv_layout="paged")),
        ("dense", dict(kv_layout="rows", kv_blocks=9)),
        ("dense", dict(kv_layout="rows", host_kv_blocks=4)),
        ("dense", dict(kv_layout="rows", swap_policy=object())),
        ("moe", dict(prefix_cache_slots=2)),
        ("moe", dict(tier="prefill")),
    ], ids=["layout", "tier_prefill", "tier_decode", "paged_moe", "kv_blocks", "host_kv_blocks",
            "swap_policy", "moe_prefix_cache", "moe_tier"])
    def test_refusal_messages_match_reference(self, models, name, kw):
        got, want = self._messages(models, name, **kw)
        assert got == want

    def test_kernel_backend_refused_on_rows(self, models):
        """``attn_backend="cuda"`` is refused on rows as the reference
        refuses its kernel backend, ``"pallas"``."""
        jcfg, tcfg, jparams, tparams = models["dense"]
        with pytest.raises(ValueError) as want:
            JaxEngine(jparams, jcfg, slots=2, prompt_slots=8, max_new_cap=4, kv_layout="rows",
                      attn_backend="pallas")
        with pytest.raises(ValueError) as got:
            ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=4, kv_layout="rows",
                        attn_backend="cuda", device="cpu")
        assert str(got.value) == str(want.value).replace("'pallas'", "'cuda'")

    def test_defaults(self, models):
        _, tcfg, _, tparams = models["moe"]
        eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=4, device="cpu")
        assert (eng.kv_layout, eng.attn_backend, eng.block_size) == ("rows", "gather", None)
        _, dcfg, _, dparams = models["dense"]
        assert ServeEngine(dparams, dcfg, slots=2, prompt_slots=8, max_new_cap=4,
                           device="cpu").kv_layout == "paged"

    def test_handoff_refused_on_rows(self, models):
        _, tcfg, _, tparams = models["dense"]
        eng = ServeEngine(tparams, tcfg, device="cpu", **SPEC)
        eng.submit([1, 2, 3], 4)
        eng.tick()
        with pytest.raises(RuntimeError, match="handoff_out needs kv_layout='paged'"):
            eng.handoff_out(0, mode="alias")
        with pytest.raises(RuntimeError, match="handoff_in needs kv_layout='paged'"):
            eng.handoff_in({"request": None, "mode": "alias", "blocks": []})


class TestSmokeSchedule:
    """chip_smoke.py's rows-and-MoE phase at a tiny width on the CPU: the
    main stream (16 requests, 8 slots, prompt_slots 512, max_new_cap 64)
    through the MoE rows engine greedy (continuous) and sampled (fused
    ticks of 4), and the shared-prefix stream on dense rows with the
    prefix cache and after a warm restart.  Requests finish on their
    budgets, so the counts do not depend on the width: the chip run must
    show these."""

    WIDTH = dict(vocab=32768, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=1024, batch=1)

    def test_counts(self):
        import chip_smoke

        gen = torch.Generator().manual_seed(0)
        moe = tburnin.BurninConfig(**self.WIDTH, **chip_smoke.MOE)
        params = tburnin.init_params(moe, gen, device="cpu")
        stream = chip_smoke.make_stream(moe.vocab)
        got = {}
        for label, kw in chip_smoke.ROWS_RUNS.items():
            eng = ServeEngine(params, moe, prompt_slots=512, max_new_cap=64, device="cpu", **kw)
            waves = chip_smoke.count_waves([eng])
            _submit(eng, [(p, b, 0) for p, b in stream])
            eng.run()
            got[label] = (waves[0], eng.device_steps, eng.wasted_steps,
                          chip_smoke.device_calls(eng))
        assert got == chip_smoke.ROWS_SCHEDULE

        dense = tburnin.BurninConfig(**self.WIDTH)
        params = tburnin.init_params(dense, gen, device="cpu")
        pstream = chip_smoke.prefix_stream(dense.vocab)
        eng = ServeEngine(params, dense, slots=8, prompt_slots=512, max_new_cap=64,
                          kv_layout="rows", prefix_cache_slots=8, device="cpu")
        ids = [eng.submit(p, b) for p, b in pstream]
        eng.run()
        reused = [eng.request(i).prefix_reused for i in ids]
        assert reused == [0] + [384] * 15
        index = eng.export_prefix_index()
        warm = ServeEngine(params, dense, slots=8, prompt_slots=512, max_new_cap=64,
                           kv_layout="rows", prefix_cache_slots=8, device="cpu")
        assert warm.warm_start(index) == len(index["entries"])
        ids = [warm.submit(p, b) for p, b in pstream]
        warm.run()
        assert [warm.request(i).prefix_reused for i in ids] == [384] * 16

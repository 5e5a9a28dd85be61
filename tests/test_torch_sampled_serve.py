"""The port's sampled serving engine (tpu_dra_torch/parallel/serve.py:
``temperature``/``top_k``/``top_p``, ``with_logprobs``,
``scheduling="tick"``) against the reference's engine
(tpu_dra/parallel/serve.py, paged layout, gather backend) on the
reference's weights, with the same stream, seeds and filters.

- Tokens equal the reference's up to the first divergence, which must be
  a near-tie of the reference's perturbed logits (test_torch_sample's
  rule and tolerance, the key ``fold_in(PRNGKey(seed), position)``);
  logprobs before it within ``2 * 2**-6 * max|logit|`` (the port's
  logits are the reference's within 2 bf16 ulps, not bitwise).
- Under fused ticks the engines are ticked together: ``device_steps`` and
  ``wasted_steps`` equal after every tick.
- The port's outputs are scheduling-invariant (slot counts,
  ``steps_per_tick``, both scheduling modes), as the reference pins its
  own (test_continuous.py), and survive preemption and both handoff
  modes of a `DisaggServer` unchanged.
- A row that steps past the context under a fused tick runs on scratch:
  no index leaves its range and nothing but scratch block 0 is written.
- chip_smoke.py's sampled phase at a tiny width: its counts, which the
  chip run must show."""

import jax
import numpy as np
import pytest
import torch

from helpers import assert_kv_conserved
from test_torch_burnin import CONFIGS, both_params
from test_torch_sample import assert_sequences_match, generated_rows
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import paged as tpaged
from tpu_dra_torch.parallel.disagg import DisaggServer
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)

SPEC = dict(slots=3, prompt_slots=8, max_new_cap=6, prefix_window=2)
SAMPLING = {"plain": dict(temperature=0.8), "filtered": dict(temperature=0.8, top_k=20, top_p=0.9)}
SCHEDULES = {"continuous": dict(scheduling="continuous", steps_per_tick=2),
             "tick": dict(scheduling="tick", steps_per_tick=3)}


def _stream(vocab, n=7, seed=3):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, vocab, rng.randint(1, 9))], int(rng.randint(1, 7)),
             int(rng.randint(-2 ** 31, 2 ** 31))) for _ in range(n)]


def _submit(eng, reqs):
    return [eng.submit(p, b, seed=s) for p, b, s in reqs]


def _port(tparams, tcfg, **kw):
    return ServeEngine(tparams, tcfg, device="cpu", **{**SPEC, **kw})


def _drain(eng, reqs):
    ids = _submit(eng, reqs)
    eng.run()
    return [eng.request(i) for i in ids]


def assert_engine_matches(jcfg, jparams, reqs, got, want, kw, logprobs=True):
    """Per request: the reference's tokens up to a near-tie, logprobs
    within the logit tolerance before it."""
    T = kw["temperature"]

    def gumbel(i, j):
        seed, pos = reqs[i][2], len(reqs[i][0]) + j
        k = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        return np.asarray(jax.random.gumbel(k, (jcfg.vocab,)))

    wtoks = [list(r.tokens) for r in want]
    rows = generated_rows(jcfg, jparams, [r[0] for r in reqs], wtoks)
    assert_sequences_match([r.tokens for r in got], wtoks, rows, gumbel, T, kw.get("top_k"),
                           kw.get("top_p"), [r.logprobs for r in got] if logprobs else None,
                           [r.logprobs for r in want] if logprobs else None)


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = CONFIGS["dense"]
    jparams, tparams = both_params(jcfg)
    return jcfg, tcfg, jparams, tparams


class TestReferenceParity:
    @pytest.mark.parametrize("sched", sorted(SCHEDULES))
    @pytest.mark.parametrize("sampling", sorted(SAMPLING))
    def test_tokens_logprobs_and_steps_match_tick_by_tick(self, dense, sampling, sched):
        jcfg, tcfg, jparams, tparams = dense
        kw = {**SAMPLING[sampling], **SCHEDULES[sched], "with_logprobs": True}
        reqs = _stream(jcfg.vocab)
        jeng = JaxEngine(jparams, jcfg, attn_backend="gather", **SPEC, **kw)
        teng = _port(tparams, tcfg, **kw)
        jids, tids = _submit(jeng, reqs), _submit(teng, reqs)
        while jeng.pending or teng.pending:
            jeng.tick()
            teng.tick()
            assert (teng.device_steps, teng.wasted_steps) == (jeng.device_steps, jeng.wasted_steps)
            assert_kv_conserved(teng)
        if sched == "tick":
            assert teng.wasted_steps > 0
        else:
            assert teng.wasted_steps == 0
        got, want = [teng.request(i) for i in tids], [jeng.request(i) for i in jids]
        assert [len(r.logprobs) for r in got] == [len(r.tokens) for r in got]
        assert all(lp <= 0 and np.isfinite(lp) for r in got for lp in r.logprobs)
        assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
        assert_engine_matches(jcfg, jparams, reqs, got, want, kw)

    def test_int8_weights_and_pool_match(self):
        jcfg, tcfg = CONFIGS["dense"]
        jparams, tparams = both_params(jcfg, quantized=True)
        kw = dict(temperature=0.9, top_k=20, kv_int8=True)
        reqs = _stream(jcfg.vocab, n=4, seed=8)
        want = _drain(JaxEngine(jparams, jcfg, attn_backend="gather", **SPEC, **kw), reqs)
        got = _drain(_port(tparams, tcfg, **kw), reqs)
        rows = generated_rows(jcfg, jparams, [r[0] for r in reqs], [list(r.tokens) for r in want],
                              kv_int8=True)
        assert_sequences_match(
            [r.tokens for r in got], [list(r.tokens) for r in want], rows,
            lambda i, j: np.asarray(jax.random.gumbel(jax.random.fold_in(
                jax.random.PRNGKey(reqs[i][2]), len(reqs[i][0]) + j), (jcfg.vocab,))),
            0.9, 20)

    def test_default_engine_skips_logprobs(self, dense):
        _, tcfg, _, tparams = dense
        for kw in (dict(), dict(temperature=0.7)):
            reqs = _drain(_port(tparams, tcfg, **kw), _stream(tcfg.vocab, n=3))
            assert all(r.tokens and r.logprobs == [] for r in reqs)

    def test_greedy_logprobs_recorded(self, dense):
        jcfg, tcfg, jparams, tparams = dense
        reqs = _stream(jcfg.vocab, n=4, seed=5)
        want = _drain(JaxEngine(jparams, jcfg, attn_backend="gather", with_logprobs=True, **SPEC),
                      reqs)
        got = _drain(_port(tparams, tcfg, with_logprobs=True), reqs)
        rows = generated_rows(jcfg, jparams, [r[0] for r in reqs], [list(r.tokens) for r in want])
        assert_sequences_match([r.tokens for r in got], [list(r.tokens) for r in want], rows,
                               None, 0.0, None, None, [r.logprobs for r in got],
                               [r.logprobs for r in want])

    @pytest.mark.parametrize("kw", [dict(scheduling="fused"), dict(top_k=5),
                                    dict(temperature=0.5, top_p=1.5),
                                    dict(temperature=0.5, top_k=65)])
    def test_validation_matches_reference(self, dense, kw):
        jcfg, tcfg, jparams, tparams = dense
        with pytest.raises(ValueError) as want:
            JaxEngine(jparams, jcfg, attn_backend="gather", **SPEC, **kw)
        with pytest.raises(ValueError) as got:
            _port(tparams, tcfg, **kw)
        assert str(got.value) == str(want.value)


class TestSchedulingInvariance:
    def test_outputs_invariant_across_slots_and_ticks(self, dense):
        """Sampled output is a function of (seed, position): every slot
        count, ``steps_per_tick`` and scheduling mode gives the same
        tokens and logprobs."""
        _, tcfg, _, tparams = dense
        reqs = _stream(tcfg.vocab, n=6, seed=11)
        outs = {}
        for slots, sched, spt in ((1, "continuous", 1), (2, "tick", 2), (3, "tick", 4),
                                  (5, "continuous", 3), (3, "tick", 1)):
            done = _drain(_port(tparams, tcfg, temperature=0.8, top_p=0.9, with_logprobs=True,
                                slots=slots, scheduling=sched, steps_per_tick=spt), reqs)
            outs[(slots, sched, spt)] = [(r.tokens, r.logprobs) for r in done]
        first = next(iter(outs.values()))
        for key, out in outs.items():
            assert out == first, key

    def test_wasted_steps_counted_in_tick_mode_zero_in_continuous(self, dense):
        """Budget 2 is the admission token and one decode step, so a fused
        4-step call wastes 3 steps a request (ref test_continuous.py)."""
        _, tcfg, _, tparams = dense
        for sched, wasted, steps in (("tick", 6, 4), ("continuous", 0, 1)):
            eng = _port(tparams, tcfg, slots=2, scheduling=sched, steps_per_tick=4,
                        temperature=0.5)
            for _ in range(2):
                eng.submit([2, 7], 2)
            eng.run()
            assert (eng.wasted_steps, eng.device_steps) == (wasted, steps)


class TestOverrun:
    # prompt_slots + max_new_cap == seq == 32 and block 3: the table
    # reaches slot 32, one past the context.
    SPEC = dict(slots=2, prompt_slots=18, max_new_cap=14)

    def test_budget_ending_on_the_last_slot_under_fused_ticks(self, dense):
        """An 18-token prompt with budget 14 puts its last token in slot
        31, the context's last: 13 decode steps, so the fourth 4-step call
        burns 3 steps feeding positions 31, 32 and 33.  Nothing raises,
        the tokens are the continuous engine's, and the pool differs from
        the continuous engine's only in scratch and in the one in-range
        burnt write (slot 31 of the row's own last block, freed since);
        the parked prompt entry's blocks are untouched."""
        jcfg, tcfg, jparams, tparams = dense
        prompt = [int(t) for t in np.random.RandomState(2).randint(0, jcfg.vocab, 18)]
        runs = {}
        for sched in ("tick", "continuous"):
            eng = ServeEngine(tparams, tcfg, device="cpu", temperature=0.9, scheduling=sched,
                              steps_per_tick=4, prefix_cache_slots=1, **self.SPEC)
            rid = eng.submit(prompt, 14, seed=5)
            eng.run()
            req = eng.request(rid)
            assert req.finish_reason == "budget" and len(req.tokens) == 14
            runs[sched] = (req.tokens, eng.wasted_steps, eng._pool)
            parked = {b for e in eng._prefix._entries for b in e.blocks}
        assert runs["tick"][0] == runs["continuous"][0]
        assert runs["tick"][1] == 3 and runs["continuous"][1] == 0
        for leaf in ("k", "v"):
            diff = (runs["tick"][2][leaf] != runs["continuous"][2][leaf]).flatten(3).any(-1)
            written = {tuple(bs) for bs in diff.any(0).nonzero().tolist()}  # (block, slot)
            others = {(b, slot) for b, slot in written if b != 0}
            assert len(others) == 1 and next(iter(others))[1] == 31 % 3, written
            assert not {b for b, _ in others} & parked
        jeng = JaxEngine(jparams, jcfg, attn_backend="gather", temperature=0.9, scheduling="tick",
                         steps_per_tick=4, **self.SPEC)
        jid = jeng.submit(prompt, 14, seed=5)
        jeng.run()
        assert jeng.wasted_steps == 3
        assert_engine_matches(jcfg, jparams, [(prompt, 14, 5)], [eng.request(rid)],
                              [jeng.request(jid)], dict(temperature=0.9), logprobs=False)

    @pytest.mark.parametrize("backend", ["gather", "cuda"])
    def test_overrun_rows_write_scratch_only(self, dense, backend):
        """A step with rows at and past the reach (and one in range): the
        pool changes in scratch block 0 and in the in-range row's slot
        alone, whatever the overrun rows' tables name.  ``"cuda"`` runs
        the kernel's plain version on the CPU."""
        _, tcfg, _, tparams = dense
        W, NW = 4, 8  # reach 32 == seq
        pool = tpaged.init_block_pool(tcfg, 20, W, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for leaf in pool.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        before = {k: v.clone() for k, v in pool.items()}
        table = torch.arange(1, 1 + 3 * NW, dtype=torch.int32).view(3, NW) % 19 + 1
        pos = torch.tensor([32, 35, 9], dtype=torch.int32)
        tok = torch.tensor([1, 2, 3], dtype=torch.int32)
        logits, _ = tpaged.paged_decode_step_rows(tparams, tok, pool, table, pos, tcfg,
                                                  backend=backend)
        assert torch.isfinite(logits).all()
        own = int(table[2, 9 // W])
        for leaf in ("k", "v"):
            changed = (pool[leaf] != before[leaf]).flatten(2).any(-1)  # (L, NB)
            blocks = sorted(set(changed.nonzero()[:, 1].tolist()))
            assert blocks == sorted({0, own}), blocks
            slots = (pool[leaf][:, own] != before[leaf][:, own]).flatten(2).any(-1)
            assert slots.nonzero()[:, 1].unique().tolist() == [9 % W]


class TestPreemptionAndTiers:
    def test_preempted_request_keeps_its_tokens(self, dense):
        """A priority-5 request preempts a sampled priority-0 row in a
        floor-sized pool; both equal the same requests served alone."""
        _, tcfg, _, tparams = dense
        kw = dict(temperature=0.8, top_k=20, with_logprobs=True)
        reqs = [([5, 9, 2, 7, 11, 3], 5, 17), ([1, 2, 3], 5, 23)]
        eng = _port(tparams, tcfg, slots=2, max_new_cap=5, kv_blocks=8, **kw)
        low = eng.submit(*reqs[0][:2], seed=reqs[0][2])
        eng.tick()
        high = eng.submit(*reqs[1][:2], seed=reqs[1][2], priority=5)
        eng.run()
        assert eng.request(low).preemptions == 1
        for rid, (p, b, s) in zip((low, high), reqs):
            alone = _drain(_port(tparams, tcfg, slots=1, max_new_cap=5, **kw), [(p, b, s)])[0]
            assert (eng.request(rid).tokens, eng.request(rid).logprobs) == (alone.tokens,
                                                                             alone.logprobs)

    @pytest.mark.parametrize("mode", ["alias", "dma"])
    def test_disagg_tiers_equal_the_mono_engine(self, dense, mode):
        _, tcfg, _, tparams = dense
        kw = dict(temperature=0.8, top_p=0.9, with_logprobs=True)
        reqs = _stream(tcfg.vocab, n=6, seed=4)
        mono = _drain(_port(tparams, tcfg, max_new_cap=6, **kw), reqs)
        spec = dict(SPEC, device="cpu", **kw)
        srv = DisaggServer(tparams, tcfg, prefill=dict(spec, slots=2), decode=dict(spec),
                           handoff=mode)
        dids = [srv.submit(p, b, seed=s) for p, b, s in reqs]
        while srv.pending:
            srv.tick()
            assert_kv_conserved(srv)
        got = [srv.result(d) for d in dids]
        assert [(r.tokens, r.logprobs) for r in got] == [(r.tokens, r.logprobs) for r in mono]


class TestSmokeSchedule:
    """chip_smoke.py's sampled phase at a tiny width on the CPU: its
    16-request stream through 8 slots (prompt_slots 512, max_new_cap 64)
    sampled at temperature 0.8, top_k 50, top_p 0.95 with logprobs;
    continuous, fused ticks of 4, and continuous at 4 slots.  Requests
    finish on their budgets, so the schedule does not depend on the
    width: the chip run must show these counts.  The two 8-slot runs give
    the same tokens and logprobs; the 4-slot run the same tokens, its
    logprobs within 2**-4 (its products have another batch shape, so a
    logit may land one bf16 ulp away: measured 0.0155 on one token)."""

    WIDTH = dict(vocab=32768, d_model=32, n_heads=4, d_ff=64, n_layers=8, seq=1024, batch=1)
    # (waves, device steps, wasted steps, device calls) of each run; host
    # syncs are calls + waves.
    SCHEDULE = {"continuous": (8, 113, 0, 113), "tick": (8, 116, 29, 29),
                "continuous 4 slots": (12, 181, 0, 181)}

    def test_counts_and_tokens(self):
        import chip_smoke
        from tpu_dra_torch.parallel import burnin as tburnin

        cfg = tburnin.BurninConfig(**self.WIDTH)
        params = tburnin.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        stream = chip_smoke.make_stream(cfg.vocab)
        got, outs = {}, {}
        for label, kw in chip_smoke.SAMPLED_RUNS.items():
            eng = ServeEngine(params, cfg, prompt_slots=512, max_new_cap=64, device="cpu",
                              **chip_smoke.SAMPLING, **kw)
            waves = chip_smoke.count_waves([eng])
            ids = [eng.submit(p, b) for p, b in stream]
            eng.run()
            got[label] = (waves[0], eng.device_steps, eng.wasted_steps,
                          chip_smoke.device_calls(eng))
            outs[label] = [(eng.request(i).tokens, eng.request(i).logprobs) for i in ids]
        assert got == self.SCHEDULE == chip_smoke.SAMPLED_SCHEDULE
        assert outs["tick"] == outs["continuous"]
        for (t4, l4), (t8, l8) in zip(outs["continuous 4 slots"], outs["continuous"]):
            assert t4 == t8
            assert max(abs(a - b) for a, b in zip(l4, l8)) <= 2 ** -4

    def test_speculative_full_depth_rounds(self):
        """The smoke's speculative shapes (a 128-token prompt, 64 new, 4
        drafted a round) with a full-depth draft, greedy and at
        temperature 0.8: every draft accepted, so 13 rounds of 5 tokens,
        as the chip run's acceptance gate (>= 0.95) expects."""
        import chip_smoke
        from tpu_dra_torch.parallel import burnin as tburnin
        from tpu_dra_torch.parallel import prng
        from tpu_dra_torch.parallel import speculative as tspec

        cfg = tburnin.BurninConfig(**self.WIDTH)
        params = tburnin.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        prompt = torch.tensor(np.random.RandomState(5).randint(0, cfg.vocab, (1, 128)),
                              dtype=torch.int32)
        for T in (0.0, 0.8):
            fn = tspec.make_generate_speculative(cfg, prompt_len=128, steps=64,
                                                 draft_layers=cfg.n_layers, draft_len=4,
                                                 temperature=T, with_stats=True)
            args = (params, prompt) + ((prng.key(7),) if T else ())
            (_, rounds, ok), accepted = chip_smoke.speculative_rounds(tspec, fn, *args)
            assert bool(ok) and rounds == 13 and accepted == [4] * 12

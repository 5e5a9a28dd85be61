"""The port's disaggregated prefill/decode server
(tpu_dra_torch/parallel/disagg.py, with the engine's ``tier`` and
handoff) against the reference's (tpu_dra/parallel/disagg.py) on the
reference's weights, at tests/test_disagg.py's config and stream.

- Lockstep: the two servers serve the stream tick by tick, in both
  handoff modes, also with a one-slot decode tier whose queue cap of 1
  defers handoffs, and (dma) with a staging pool of one worst-case row.
  After every tick `disagg_stats()` is equal apart from the server's
  name, each tier's block counters are equal, the reference's
  cross-tier conservation check holds on the port's server, and under
  alias both tiers still share one pool dict and one allocator.
- Tokens equal the reference's isolated oracle (test_serve.isolated), or
  first differ where the reference is at a near-tie
  (test_torch_prefix.assert_same_tokens).
- Alias moves references only (no block read, written or copied); dma
  allocates a fresh block for every one moved.
- Every contract of test_disagg.TestContracts holds, with the same error
  patterns."""

import pytest
import torch

from helpers import assert_kv_conserved
from test_disagg import STREAM
from test_serve import isolated
from test_torch_prefix import assert_same_tokens, dense, settled  # noqa: F401
from tpu_dra.parallel.disagg import DisaggServer as JaxServer
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import serve as tserve
from tpu_dra_torch.parallel.disagg import DisaggServer

torch.set_num_threads(2)


def _specs(decode_slots=4, decode_kv=None):
    prefill = dict(slots=2, prompt_slots=8, max_new_cap=5, prefix_window=2)
    decode = dict(slots=decode_slots, prompt_slots=8, max_new_cap=5, prefix_window=2)
    if decode_kv is not None:
        decode["kv_blocks"] = decode_kv
    return prefill, decode


# (handoff, decode tier slots, decode kv_blocks, server keywords).  The
# staging pool of 7 slots holds one worst-case row ((8 + 5) / 2 blocks).
CASES = {
    "alias": ("alias", 4, None, {}),
    "dma": ("dma", 4, None, {}),
    "alias_deferred": ("alias", 1, 24, {"decode_queue_cap": 1}),
    "dma_deferred_staging_full": ("dma", 1, None, {"decode_queue_cap": 1, "staging_blocks": 7}),
}
_RUNS: dict = {}


def _port_server(tparams, tcfg, mode, decode_slots=4, decode_kv=None, **kw):
    prefill, decode = _specs(decode_slots, decode_kv)
    return DisaggServer(tparams, tcfg, prefill=dict(prefill, device="cpu"),
                        decode=dict(decode, device="cpu"), handoff=mode, **kw)


def _stats(srv):
    out = srv.disagg_stats()
    out.pop("server")
    return out


def _lockstep(dense, case, max_ticks=200):
    """The stream through both servers in lockstep (cached per case);
    returns the port's Request objects, the reference's, and the port's
    server."""
    if case in _RUNS:
        return _RUNS[case]
    jcfg, tcfg, jparams, tparams = dense
    mode, decode_slots, decode_kv, kw = CASES[case]
    prefill, decode = _specs(decode_slots, decode_kv)
    jsrv = JaxServer(jparams, jcfg, prefill=dict(prefill, attn_backend="gather"),
                     decode=dict(decode, attn_backend="gather"), handoff=mode,
                     name=f"ref-{case}", **kw)
    for eng in jsrv.tiers.values():
        settled(eng)
    tsrv = _port_server(tparams, tcfg, mode, decode_slots, decode_kv, name=f"port-{case}", **kw)
    jids = [jsrv.submit(p, m, priority=pr) for p, m, pr in STREAM]
    tids = [tsrv.submit(p, m, priority=pr) for p, m, pr in STREAM]
    for _ in range(max_ticks):
        if not (jsrv.pending or tsrv.pending):
            break
        jsrv.tick()
        tsrv.tick()
        assert _stats(tsrv) == _stats(jsrv)
        for tier in ("prefill", "decode"):
            assert tsrv.tiers[tier].kv_block_stats == jsrv.tiers[tier].kv_block_stats, tier
        assert_kv_conserved(tsrv)
        if mode == "alias":
            pre, dec = tsrv.tiers["prefill"], tsrv.tiers["decode"]
            assert pre._pool is dec._pool and pre._balloc is dec._balloc
    assert not (jsrv.pending or tsrv.pending), "servers did not drain"
    treqs = [tsrv.result(d) for d in tids]
    jreqs = [jsrv.result(d) for d in jids]
    jsrv.close()
    tsrv.close()
    _RUNS[case] = (treqs, jreqs, tsrv)
    return _RUNS[case]


@pytest.fixture(scope="module")
def oracle(dense):
    """The reference's isolated oracle over the stream."""
    jcfg, _, jparams, _ = dense
    return [list(isolated(jparams, jcfg, p, m)) for p, m, _ in STREAM]


class TestLockstep:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_stats_and_blocks_equal_every_tick_and_tokens_match_oracle(self, dense, oracle,
                                                                       case):
        jcfg, _, jparams, _ = dense
        treqs, jreqs, tsrv = _lockstep(dense, case)
        mode = CASES[case][0]
        for t, j in zip(treqs, jreqs):
            assert t.done and j.done
            assert (t.finish_reason, t.handoffs, t.handoff_blocks, t.handoff_mode) == (
                j.finish_reason, j.handoffs, j.handoff_blocks, j.handoff_mode)
            assert t.handoffs == 1 and t.handoff_mode == mode and t.handoff_blocks > 0
            assert t.replica == tsrv.tiers["decode"].name
        assert_same_tokens(jcfg, jparams, [p for p, _, _ in STREAM],
                           [t.tokens for t in treqs], oracle)
        stats = tsrv.disagg_stats()
        assert stats["prefill"]["handoff_out_requests"] == len(STREAM)
        assert stats["decode"]["handoff_in_requests"] == len(STREAM)
        assert stats["decode"][f"handoffs_{mode}"] == len(STREAM)
        if case.endswith("deferred") or "staging_full" in case:
            assert stats["deferred_handoffs"] > 0
        # The prefill tier ran no decode step.
        assert tsrv.tiers["prefill"].device_steps == 0


class TestZeroCopy:
    def test_alias_moves_references_only(self, dense, monkeypatch):
        """Under alias no block is read, written or copied, and the
        decode tier aliases every block it takes in."""
        calls = []
        for name in ("copy_block", "write_block", "read_block"):
            real = getattr(tserve, name)
            monkeypatch.setattr(tserve, name,
                                lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
        _, tcfg, _, tparams = dense
        tsrv = _port_server(tparams, tcfg, "alias")
        dids = [tsrv.submit(p, m, priority=pr) for p, m, pr in STREAM]
        tsrv.run()
        treqs = [tsrv.result(d) for d in dids]
        assert calls == []
        assert all(r.done and r.handoff_mode == "alias" for r in treqs)
        dec = tsrv.tiers["decode"]
        moved = sum(r.handoff_blocks for r in treqs)
        assert dec._kv_counts["alias_blocks"] == moved
        assert dec._kv_counts["alloc_blocks"] == 0

    def test_dma_allocates_every_block_it_moves(self, dense):
        treqs, _, tsrv = _lockstep(dense, "dma")
        dec = tsrv.tiers["decode"]
        assert dec._kv_counts["alloc_blocks"] == sum(r.handoff_blocks for r in treqs)
        assert dec._kv_counts["alias_blocks"] == 0
        assert tsrv.staging.used_count == 0


class TestSharing:
    def test_alias_drops_the_prefill_pool_and_shares_the_weights(self, dense, monkeypatch):
        import weakref

        _, tcfg, _, tparams = dense
        prefill, decode = _specs()
        made = []
        real = tserve.init_block_pool

        def tracked(*a, **kw):
            pool = real(*a, **kw)
            made.append(weakref.ref(pool["k"]))
            return pool

        monkeypatch.setattr(tserve, "init_block_pool", tracked)
        srv = DisaggServer(tparams, tcfg, prefill=dict(prefill, device="cpu"),
                           decode=dict(decode, device="cpu"), handoff="alias")
        pre, dec = srv.tiers["prefill"], srv.tiers["decode"]
        # The prefill engine's own pool (made first) is gone already.
        assert made[0]() is None and made[1]() is dec._pool["k"]
        assert pre._pool is dec._pool and pre._balloc is dec._balloc
        for name in ("wqkv", "wo", "w1", "w2"):
            assert pre.params["layers"][name] is dec.params["layers"][name]
        srv.close()


class TestContracts:
    def test_engine_tier_validation(self, dense):
        jcfg, tcfg, jparams, tparams = dense
        with pytest.raises(ValueError, match="tier must be") as got:
            tserve.ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=4,
                               tier="middle", device="cpu")
        with pytest.raises(ValueError) as want:
            JaxEngine(jparams, jcfg, slots=1, prompt_slots=8, max_new_cap=4, tier="middle")
        assert str(got.value) == str(want.value)

    def test_handoff_engine_contract(self, dense):
        _, tcfg, _, tparams = dense
        eng = tserve.ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=4,
                                 prefix_window=2, name="ho-contract", device="cpu")
        with pytest.raises(ValueError, match="mode must be"):
            eng.handoff_out(0, mode="teleport")
        with pytest.raises(ValueError, match="requires a staging"):
            eng.handoff_out(0, mode="dma")
        with pytest.raises(ValueError, match="no in-flight request"):
            eng.handoff_out(0, mode="alias")
        eng.close()

    @pytest.mark.parametrize(
        "kw,match",
        [
            (dict(handoff="teleport"), "handoff must be"),
            (dict(prefill_extra=dict(tier="mono")), "must not set"),
            (dict(prefill_extra=dict(kv_blocks=64), handoff="alias"), "ONE device pool"),
            (dict(handoff="alias", staging_blocks=8), "staging_blocks only"),
            (dict(decode_extra=dict(prefix_window=4)), "share one block size"),
            (dict(decode_extra=dict(kv_int8=True)), "share one pool format"),
            (dict(handoff="dma", staging_blocks=2), "staging_blocks must be"),
            (dict(decode_extra=dict(prompt_slots=2, max_new_cap=2, kv_blocks=6)),
             "shared pool"),
            (dict(prefill_wave=3), "prefill_wave must be"),
            (dict(decode_queue_cap=0), "decode_queue_cap must be"),
        ],
    )
    def test_server_spec_validation(self, dense, kw, match):
        _, tcfg, _, tparams = dense
        prefill, decode = _specs()
        kw = dict(kw)
        prefill.update(kw.pop("prefill_extra", {}))
        decode.update(kw.pop("decode_extra", {}))
        with pytest.raises(ValueError, match=match):
            DisaggServer(tparams, tcfg, prefill=dict(prefill, device="cpu"),
                         decode=dict(decode, device="cpu"), **kw)

    def test_doomed_request_fails_at_submit(self, dense):
        _, tcfg, _, tparams = dense
        prefill, _ = _specs()
        small = dict(slots=2, prompt_slots=2, max_new_cap=2, prefix_window=2, kv_blocks=8)
        srv = DisaggServer(tparams, tcfg, prefill=dict(prefill, device="cpu"),
                           decode=dict(small, device="cpu"), name="small-dec")
        with pytest.raises(ValueError, match="decode-tier row"):
            srv.submit([5, 9, 2, 7, 11, 3], 5)
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit([5], 1)
        with pytest.raises(RuntimeError, match="closed"):
            srv.tick()


class TestPrefillTierCache:
    def test_prefill_tier_prefix_cache_under_alias(self, dense):
        """A prefix cache on the prefill tier refs its blocks in the one
        shared allocator (the reference's entries keep the dropped
        allocator and fail its first insert: ROADMAP Queue 3): hits
        alias, blocks are conserved every tick, tokens equal the
        reference's isolated oracle up to a near-tie."""
        jcfg, tcfg, jparams, tparams = dense
        prefill, decode = _specs()
        srv = DisaggServer(tparams, tcfg, prefill=dict(prefill, prefix_cache_slots=2, device="cpu"),
                           decode=dict(decode, device="cpu"), handoff="alias")
        pre = srv.tiers["prefill"]
        assert pre._prefix._alloc is srv.tiers["decode"]._balloc
        stream = [([5, 9, 2, 7, 11, 3, i + 1], 3) for i in range(4)]
        dids = [srv.submit(p, m) for p, m in stream]
        while srv.pending:
            srv.tick()
            assert_kv_conserved(srv)
        assert pre.prefix_stats["hits"] > 0 and pre.prefix_stats["prefill_tokens_reused"] > 0
        want = [list(isolated(jparams, jcfg, p, m)) for p, m in stream]
        assert_same_tokens(jcfg, jparams, [p for p, _ in stream],
                           [srv.result(d).tokens for d in dids], want)
        srv.close()


class TestSmokeSchedule:
    """The server at chip_smoke.py's disagg shapes (8 slots a tier,
    prompt_slots 512, max_new_cap 64, block 128, a 41-block decode pool,
    the default staging pool) over its 16-request stream, at a tiny width
    on the CPU.  Greedy requests finish on their budgets, so the schedule
    (waves, steps, handoffs, deferrals) does not depend on the width: the
    chip run must show these counts.  Tokens equal the port's mono
    engine's."""

    WIDTH = dict(vocab=32768, d_model=32, n_heads=4, d_ff=64, n_layers=8, seq=1024, batch=1)
    # (prefill-tier waves, decode-tier steps, deferred handoffs, blocks
    # handed off) for each mode; the mono engine's steps and waves.
    SCHEDULE = {"alias": (7, 114, 0, 48), "dma": (7, 114, 225, 48), "mono": (8, 113)}

    def test_counts_and_tokens(self):
        import chip_smoke
        from tpu_dra_torch.parallel import burnin as tburnin

        cfg = tburnin.BurninConfig(**self.WIDTH)
        params = tburnin.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        stream = chip_smoke.make_stream(cfg.vocab)
        spec = dict(slots=8, prompt_slots=512, max_new_cap=64, device="cpu")
        mono = tserve.ServeEngine(params, cfg, **spec)
        waves = chip_smoke.count_waves([mono])
        ids = [mono.submit(p, b) for p, b in stream]
        mono.run()
        want = [mono.request(i).tokens for i in ids]
        got = {"mono": (waves[0], mono.device_steps)}
        for mode in ("alias", "dma"):
            srv = DisaggServer(params, cfg, prefill=dict(spec), decode=dict(spec, kv_blocks=41),
                               handoff=mode)
            pre, dec = srv.tiers["prefill"], srv.tiers["decode"]
            waves = chip_smoke.count_waves([pre, dec])
            dids = [srv.submit(p, b) for p, b in stream]
            while srv.pending:
                srv.tick()
                assert_kv_conserved(srv)
            assert [srv.result(d).tokens for d in dids] == want
            assert pre.device_steps == 0
            stats = srv.disagg_stats()
            got[mode] = (waves[0], dec.device_steps, stats["deferred_handoffs"],
                         stats["decode"]["handoff_in_blocks"])
        assert got == self.SCHEDULE

    def test_warm_restart_counts_and_tokens(self):
        """chip_smoke.py's warm-restart phase at the tiny width: the warm
        engine reuses 384 tokens on every request, the cold one none on
        its first admission, tokens equal, and the digest claims 384
        tokens of every prompt."""
        import chip_smoke
        from tpu_dra_torch.parallel import burnin as tburnin

        cfg = tburnin.BurninConfig(**self.WIDTH)
        params = tburnin.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        stream = chip_smoke.prefix_stream(cfg.vocab)
        spec = dict(slots=8, prompt_slots=512, max_new_cap=64, prefix_cache_slots=8,
                    device="cpu")
        runs = {}
        index = None
        for label in ("cold", "warm"):
            eng = tserve.ServeEngine(params, cfg, **spec)
            warmed = eng.warm_start(index) if index else 0
            waves = chip_smoke.count_waves([eng])
            ids = [eng.submit(p, b) for p, b in stream]
            eng.run()
            reqs = [eng.request(i) for i in ids]
            runs[label] = dict(reqs=reqs, counts=(warmed, waves[0], eng.device_steps,
                                                  eng.prefix_stats["prefill_tokens_computed"]))
            if label == "cold":
                index = eng.export_prefix_index()
            else:
                assert [eng.prefix_digest().lookup(p)[0] for p, _ in stream] == [384] * 16
            eng.close()
        cold, warm = runs["cold"], runs["warm"]
        assert [r.tokens for r in warm["reqs"]] == [r.tokens for r in cold["reqs"]]
        assert [r.prefix_reused for r in warm["reqs"]] == [384] * 16
        assert min(cold["reqs"], key=lambda r: r.admitted_at).prefix_reused == 0
        # (runs warmed, waves, steps, prefill tokens computed)
        assert (cold["counts"], warm["counts"]) == ((0, 9, 103, 1544), (8, 9, 103, 4791))

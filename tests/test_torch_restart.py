"""Warm restart and the fleet-facing surface of the port's engine
(tpu_dra_torch/parallel/serve.py `export_prefix_index`, `warm_start`,
`prefix_digest`, `peek_prefix`; prefixcache.py `export_index`;
tpu_dra_torch/fleet/digest.py) against the reference's
(tpu_dra/parallel/serve.py, prefixcache.py, tpu_dra/fleet/digest.py),
mirroring tests/test_serve_restart.py on its config, weights and stream.

- The port's and the reference's engines serve one shared-prefix stream:
  the exported indexes are equal entry for entry, and the digests field
  for field apart from the build time.
- Warm-started from that index, both engines warm the same runs, hold
  the same residency and counters, and serve the stream again with the
  whole first wave hitting; the warm engine's tokens equal the cold
  engine's, and the reference's up to a near-tie
  (test_torch_prefix.assert_same_tokens).
- Stale runs are skipped, ``top_k`` is clamped to the cache's entries,
  a busy or cache-less engine is refused, the checkpoint and the digest
  stay readable after close, `peek_prefix` moves no counter.
- The digest module hashes byte for byte as the reference's."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from test_serve_restart import CFG as JCFG
from test_serve_restart import PARAMS as JPARAMS
from test_serve_restart import REQS, SYSTEM
from test_torch_prefix import assert_same_tokens, settled
from tpu_dra.fleet import digest as jdigest
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.fleet import digest as tdigest
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.parallel.weights import params_from_numpy

torch.set_num_threads(2)

TCFG = tb.BurninConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
TPARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS), device="cpu")
ENGINE = dict(slots=2, prompt_slots=32, max_new_cap=4)


def engine(**kw):
    kw.setdefault("prefix_cache_slots", 4)
    kw.setdefault("prefix_window", 8)
    return ServeEngine(TPARAMS, TCFG, **ENGINE, device="cpu", **kw)


def ref_engine(**kw):
    kw.setdefault("prefix_cache_slots", 4)
    kw.setdefault("prefix_window", 8)
    return settled(JaxEngine(JPARAMS, JCFG, **ENGINE, attn_backend="gather", **kw))


def run_stream(eng):
    ids = [eng.submit(p, 4) for p in REQS]
    eng.run()
    return [list(eng.request(i).tokens) for i in ids]


def digest_fields(d):
    return (d.replica, d.window, d.epoch, d.max_len, d.prefixes)


@pytest.fixture(scope="module")
def restart():
    """The stream through a port and a reference engine, each closed and
    restarted warm from its own index, then the stream again."""
    out = {}
    for side, make in (("port", engine), ("ref", ref_engine)):
        pre = make(name="restart-pre")
        tokens_pre = run_stream(pre)
        index = pre.export_prefix_index()
        pre.close()
        warm = make(name="restart-warm")
        warmed = warm.warm_start(index)
        warm_stats = dict(warm.prefix_stats)
        warm_kv = dict(warm.kv_block_stats)
        warm_index = warm.export_prefix_index()
        tokens_warm = run_stream(warm)
        out[side] = dict(pre=pre, warm=warm, tokens_pre=tokens_pre, tokens_warm=tokens_warm,
                         index=index, warmed=warmed, warm_stats=warm_stats, warm_kv=warm_kv,
                         warm_index=warm_index)
        warm.close()
    return out


class TestWarmRestart:
    def test_exported_index_equals_the_reference(self, restart):
        port, ref = restart["port"]["index"], restart["ref"]["index"]
        assert port["version"] == 1 and port["entries"]
        assert port == ref
        hits = [e["hits"] for e in port["entries"]]
        assert hits == sorted(hits, reverse=True)
        assert all(isinstance(e["tokens"], list) for e in port["entries"])

    def test_warm_start_matches_the_reference(self, restart):
        port, ref = restart["port"], restart["ref"]
        assert port["warmed"] == ref["warmed"] > 0
        assert port["warm_stats"] == ref["warm_stats"]
        assert port["warm_stats"]["resident"] == port["warmed"]
        assert port["warm_kv"] == ref["warm_kv"]
        assert port["warm_index"] == ref["warm_index"]

    def test_warm_tokens_equal_cold_and_first_wave_hits(self, restart):
        port, ref = restart["port"], restart["ref"]
        assert port["tokens_warm"] == port["tokens_pre"]
        assert_same_tokens(JCFG, JPARAMS, REQS, port["tokens_warm"], ref["tokens_warm"])
        warm = port["warm"]
        assert warm.prefix_stats["hits"] - port["warm_stats"]["hits"] >= len(REQS)
        assert warm.prefix_stats["prefill_tokens_computed"] == (
            port["warm_stats"]["prefill_tokens_computed"]
            + sum(len(p) for p in REQS) - warm.prefix_stats["prefill_tokens_reused"]
        )

    def test_digest_equals_the_reference_after_close(self, restart):
        for stage in ("pre", "warm"):
            port, ref = restart["port"][stage], restart["ref"][stage]
            got, want = port.prefix_digest(), ref.prefix_digest()
            assert isinstance(got, tdigest.ReplicaDigest)
            assert digest_fields(got) == digest_fields(want)
            assert got.entries > 0 and got.lookup(SYSTEM + [0]) == want.lookup(SYSTEM + [0])
            assert got.lookup(SYSTEM + [0])[0] >= 8


class TestWarmStartEdges:
    def test_skips_stale_runs_and_respects_top_k(self):
        index = {
            "version": 1,
            "entries": [
                {"tokens": SYSTEM, "hits": 9},
                {"tokens": [0] * 3, "hits": 8},        # shorter than a window
                {"tokens": [999] * 16, "hits": 7},     # out of vocabulary
                {"tokens": [1] * 64, "hits": 6},       # longer than prompt_slots
                {"tokens": [True] * 16, "hits": 6},    # not int ids
                {"tokens": [2] * 16, "hits": 5},
                {"tokens": [3] * 16, "hits": 4},
            ],
        }
        eng, ref = engine(name="edge"), ref_engine(name="edge")
        assert eng.warm_start(index, top_k=2) == ref.warm_start(index, top_k=2) == 2
        assert eng.prefix_stats == ref.prefix_stats
        assert eng.export_prefix_index() == ref.export_prefix_index()
        assert [e["tokens"] for e in eng.export_prefix_index()["entries"]] == [SYSTEM, [2] * 16]
        ref.close()

    def test_top_k_clamped_to_the_pool(self):
        index = {"entries": [{"tokens": [t] * 16, "hits": 10 - t} for t in range(6)]}
        eng = engine(name="clamp")  # 4 entries
        assert eng.warm_start(index, top_k=10) == 4
        assert eng.prefix_stats["resident"] == 4
        for t in range(4):
            entry, use, _ = eng._prefix.match([t] * 16 + [63])
            assert entry is not None and use == 16, (t, use)

    def test_evicts_for_room_in_a_small_pool(self):
        """A pool that holds fewer runs than the cache's entry cap: the
        coldest warmed tails are trimmed for the hotter runs' room, as
        the reference trims them."""
        index = {"entries": [{"tokens": [t] * 32, "hits": 10 - t} for t in range(4)]}
        eng, ref = engine(name="tight", kv_blocks=10), ref_engine(name="tight", kv_blocks=10)
        assert eng.warm_start(index) == ref.warm_start(index)
        assert eng.prefix_stats == ref.prefix_stats
        assert eng.prefix_stats["trimmed_blocks"] > 0
        assert eng.kv_block_stats == ref.kv_block_stats
        assert eng.export_prefix_index() == ref.export_prefix_index()
        ref.close()

    def test_requires_a_cache_and_an_idle_engine(self):
        bare = engine(name="bare", prefix_cache_slots=0, prefix_window=None)
        with pytest.raises(ValueError, match="no prefix cache"):
            bare.export_prefix_index()
        with pytest.raises(ValueError, match="no prefix cache"):
            bare.warm_start({"entries": []})
        assert digest_fields(bare.prefix_digest()) == digest_fields(jdigest.empty_digest("bare"))
        busy = engine(name="busy")
        busy.submit(SYSTEM, 2)
        with pytest.raises(RuntimeError, match="before admitting"):
            busy.warm_start({"entries": []})
        busy.run()

    def test_empty_checkpoints_warm_nothing(self):
        eng = engine(name="empty-export")
        eng.close()
        index = eng.export_prefix_index()
        assert index == {"version": 1, "prefix_window": 8, "entries": []}
        warm = engine(name="empty-warm")
        for idx in (index, {"version": 1, "entries": []}, {"entries": None}, {}):
            assert warm.warm_start(idx) == 0
        assert warm.prefix_stats["resident"] == 0
        warm.submit(SYSTEM, 2)
        assert warm.run()[0].tokens

    def test_closed_engine_refuses_warm_start_and_keeps_its_checkpoint(self):
        eng = engine(name="death")
        eng.submit(SYSTEM, 2)
        eng.run()
        index = eng.export_prefix_index()
        eng.close()
        for call in (lambda: eng.submit(SYSTEM, 2), eng.tick, lambda: eng.warm_start(index)):
            with pytest.raises(RuntimeError, match="closed"):
                call()
        assert eng.export_prefix_index()["entries"]
        eng.close()


class TestFleetFacingSurface:
    def test_peek_prefix_moves_no_counter(self):
        eng = engine(name="peek")
        eng.submit(REQS[0], 2)
        eng.run()
        stats = eng.prefix_stats
        assert eng.peek_prefix(SYSTEM + [0]) >= 8
        assert eng.peek_prefix([63] * 8) == 0
        after = eng.prefix_stats
        assert (after["hits"], after["misses"]) == (stats["hits"], stats["misses"])
        assert after["epoch"] == stats["epoch"] == eng.prefix_epoch > 0

    def test_backdated_enqueue_is_in_the_queue_wait(self):
        eng = engine(name="backdate")
        rid = eng.submit(REQS[0], 2, enqueued_at=time.perf_counter() - 1.5)
        eng.run()
        req = eng.request(rid)
        assert req.queue_wait_s >= 1.5 and req.ttft_s >= req.queue_wait_s
        rid2 = eng.submit(REQS[1], 2, enqueued_at=time.perf_counter() + 99)
        eng.run()
        req2 = eng.request(rid2)
        assert 0.0 <= req2.queue_wait_s <= req2.ttft_s

    def test_request_lookup_and_replica_stamp(self):
        eng = engine(name="lookup")
        rid = eng.submit(REQS[0], 2)
        assert eng.request(rid).replica == "lookup" and eng.replica_id == "lookup"
        assert eng.request(9999) is None
        eng.run()
        assert eng.request(rid).done


class TestDigestModule:
    def test_hash_run_is_the_references(self):
        rng = np.random.RandomState(5)
        runs = [[], [0], [1, 23], [12, 3]] + [
            [int(t) for t in rng.randint(0, 2**17, rng.randint(1, 300))] for _ in range(20)
        ]
        for run in runs:
            assert tdigest.hash_run(run) == jdigest.hash_run(run)

    @pytest.mark.parametrize("window", [None, 1, 8])
    def test_build_and_lookup_are_the_references(self, window):
        index = {
            "prefix_window": 8,
            "entries": [
                {"tokens": SYSTEM + [1, 2, 3], "hits": 3},
                {"tokens": SYSTEM[:16] + [5] * 9, "hits": 7},
                {"tokens": [4] * 5, "hits": 1},
            ],
        }
        got = tdigest.build_digest(index, replica="r", epoch=4, window=window)
        want = jdigest.build_digest(index, replica="r", epoch=4, window=window)
        assert digest_fields(got) == digest_fields(want)
        for prompt in (SYSTEM, SYSTEM + [0], SYSTEM[:17], [4] * 9, [9] * 30):
            assert got.lookup(prompt) == want.lookup(prompt)
        d = got.to_dict()
        d.pop("built_at"), d.pop("age_s")
        w = want.to_dict()
        w.pop("built_at"), w.pop("age_s")
        assert d == w
        with pytest.raises(ValueError, match="digest window must be"):
            tdigest.build_digest(index, replica="r", window=0)

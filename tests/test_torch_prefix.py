"""The port's shared-prefix cache (tpu_dra_torch/parallel/prefixcache.py,
the block primitives and heat records of paged.py, and the engine's
alias / copy-on-write admission in serve.py) against the reference
(tpu_dra/parallel/prefixcache.py, paged.py, serve.py) on the reference's
weights.

- The radix cache and the block allocator are driven in lockstep with the
  reference's through one seeded sequence of operations: every return
  value and every piece of state must be equal.
- `read_block`/`write_block`/`copy_block` are bitwise equal to the
  reference's on the same pools, bf16 and int8.
- The port's engine (gather backend) and the reference's (gather) serve
  one shared-prefix stream tick by tick: block and prefix counters equal
  after every tick, the reference's block-conservation check holding on
  the port's engine between ticks, ``prefix_reused`` and finish reasons
  equal, greedy tokens equal or first differing where the reference is at
  a near-tie (its top-2 margin within 2 bf16 ulps of the row's largest
  logit, recomputed by its own decode_forward).
- The kernel route's plain version over tables whose rows share blocks
  agrees with the gather step and with the reference's Pallas kernel in
  interpret mode (tolerance of test_torch_burnin)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_kv_conserved
from test_torch_burnin import CONFIGS, assert_logits_close, both_params
from tpu_dra.parallel import decode as jd
from tpu_dra.parallel import paged as jp
from tpu_dra.parallel import prefixcache as jpc
from tpu_dra.parallel import quant as jq
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import paged as tp
from tpu_dra_torch.parallel import prefixcache as tpc
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)


# -- helpers shared by the engine tests of the KV hierarchy ---------------
# The port engine's `prefix_stats` keys that the reference's engine has
# no counterpart of: the paged admission prefill's windows and the decode
# steps, by path.
PORT_ONLY_KEYS = ("prefill_windows_graph", "prefill_windows_eager", "decode_steps_graph",
                  "decode_steps_eager")


def reference_prefix_stats(stats: dict) -> dict:
    """A port engine's `prefix_stats` on the reference's keys."""
    return {k: v for k, v in stats.items() if k not in PORT_ONLY_KEYS}


def first_difference(got, want):
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def assert_same_tokens(jcfg, jparams, prompts, got, want, kv_int8=False):
    """Per request, the port's tokens equal the reference's, or first
    differ where the reference is at a near-tie."""
    for prompt, g, w in zip(prompts, got, want):
        assert len(g) == len(w), (prompt, g, w)
        i = first_difference(g, w)
        if i is None:
            continue
        seq = jnp.asarray([list(prompt) + list(w[:i])], jnp.int32)
        logits, _ = jd.decode_forward(jparams, seq, jd.init_cache(jcfg, 1, kv_int8), 0, jcfg)
        row = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= 2 ** -6 * np.abs(row).max(), (prompt, i, g, w)


def settled(jeng):
    """The reference's engine with each admission prefill waited for.
    Its `_admit_paged` rewrites the numpy table row it handed to the
    asynchronous prefill (the COW column, tpu_dra/parallel/serve.py:1768)
    without waiting for it; on the CPU backend the prefill can then write
    the partial prompt window into the COW block instead of the shared
    one, and the copy leaves both stale (ROADMAP, Queue 3)."""
    prefill = jeng._paged_prefill
    jeng._paged_prefill = lambda *args: jax.block_until_ready(prefill(*args))
    return jeng


def lockstep(jeng, teng, reqs, *, between=None, max_ticks=400):
    """Submit ``reqs`` ((prompt, budget, priority) triples, or with a
    fourth item, the tick before which it arrives) to both engines and
    tick them together until both drain: after every tick the block and
    prefix counters are equal and the port's blocks are conserved
    (``between(jeng, teng)`` runs there too).  Returns both engines'
    finished requests in submit order."""
    reqs = [r if len(r) == 4 else (*r, 0) for r in reqs]
    jids, tids = [None] * len(reqs), [None] * len(reqs)
    for tick in range(max_ticks):
        for i, (p, b, pr, at) in enumerate(reqs):
            if at == tick:
                jids[i] = jeng.submit(p, b, priority=pr)
                tids[i] = teng.submit(p, b, priority=pr)
        if tick > max(r[3] for r in reqs) and not (jeng.pending or teng.pending):
            break
        jeng.tick()
        teng.tick()
        assert teng.kv_block_stats == jeng.kv_block_stats
        assert reference_prefix_stats(teng.prefix_stats) == jeng.prefix_stats
        assert (teng.queue_depth, teng.occupancy) == (jeng.queue_depth, jeng.occupancy)
        assert_kv_conserved(teng)
        if between is not None:
            between(jeng, teng)
    assert not (jeng.pending or teng.pending), "engines did not drain"
    return [jeng.request(i) for i in jids], [teng.request(i) for i in tids]


def assert_requests_match(jcfg, jparams, reqs, jdone, tdone, kv_int8=False):
    """Finish reasons, prefix reuse and preemption counts equal; tokens
    equal up to a reference near-tie."""
    for j, t in zip(jdone, tdone):
        assert t.done and j.done
        assert (t.finish_reason, t.prefix_reused, t.preemptions, t.kv_blocks) == (
            j.finish_reason, j.prefix_reused, j.preemptions, j.kv_blocks)
    assert_same_tokens(jcfg, jparams, [r[0] for r in reqs],
                       [t.tokens for t in tdone], [list(j.tokens) for j in jdone], kv_int8)


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = CONFIGS["dense"]
    jparams, tparams = both_params(jcfg)
    return jcfg, tcfg, jparams, tparams


# -- the radix cache and the allocator, in lockstep ------------------------
def _view(entry):
    if entry is None:
        return None
    return (entry.slot, entry.length, list(entry.blocks or ()), entry.refcount, entry.hits,
            entry.last_used)


class _Twin:
    """A reference and a port PagedPrefixCache over their own allocators,
    fed the same operations."""

    def __init__(self, nb, max_entries, block_size=2):
        self.ja, self.ta = jp.BlockAllocator(nb), tp.BlockAllocator(nb)
        self.jc = jpc.PagedPrefixCache(max_entries, self.ja, block_size=block_size)
        self.tc = tpc.PagedPrefixCache(max_entries, self.ta, block_size=block_size)
        self.w = block_size
        self.pairs = []  # (reference entry, port entry) as returned together
        self.reextended = 0

    def call(self, name, *args, **kw):
        want = getattr(self.jc, name)(*args, **kw)
        got = getattr(self.tc, name)(*args, **kw)
        return want, got

    def alloc(self, n, step):
        want, got = self.ja.alloc(n, step=step), self.ta.alloc(n, step=step)
        assert got == want
        return got

    def unref(self, blocks, step=None):
        self.ja.unref(blocks, step=step)
        self.ta.unref(blocks, step=step)

    def park(self, tokens, step, release=True):
        """An admission parks ``tokens``: fresh blocks, the entry, the
        caller's references dropped (ownership moves to the entry)."""
        blocks = self.alloc(-(-len(tokens) // self.w), step)
        if blocks is None:
            return None
        old = self.tc._exact_resident(tokens)
        old_len = None if old is None else old.length
        want, got = self.call("insert", tokens, blocks)
        assert _view(got) == _view(want)
        if got is not None:
            self.pairs.append((want, got))
            self.reextended += old_len is not None and old_len < len(tokens)
            if release:
                self.call_pair("release", want, got)
        self.unref(blocks, step)
        return got

    def call_pair(self, name, want, got):
        getattr(self.jc, name)(want)
        getattr(self.tc, name)(got)

    def check(self, step):
        assert self.tc.stats() == self.jc.stats()
        assert self.tc.epoch == self.jc.epoch
        assert self.tc.export_blocks() == self.jc.export_blocks()
        assert self.ta.stats() == self.ja.stats()
        assert self.ta.free_runs() == self.ja.free_runs()
        nb = self.ja.num_blocks
        assert [self.ta.refcount(b) for b in range(nb)] == [self.ja.refcount(b) for b in range(nb)]
        assert [self.ta.last_touch_step(b) for b in range(nb)] == [
            self.ja.last_touch_step(b) for b in range(nb)]

        def records(alloc):  # ages are each allocator's own clock
            return [{k: v for k, v in r.items() if k != "age_s"}
                    for r in alloc.block_records(current_step=step)]

        assert records(self.ta) == records(self.ja)
        for want, got in self.pairs:
            assert _view(got) == _view(want)


class TestPrefixCacheTwin:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_operations_match_reference(self, seed):
        """Inserts, matches, peeks, pins and evictions over a pool too
        small for the working set: trims, deaths, re-extensions and the
        entry cap all happen, and both sides stay equal throughout."""
        rng = np.random.RandomState(seed)
        twin = _Twin(nb=14, max_entries=4)
        families = [[int(t) for t in rng.randint(0, 50, 6)] for _ in range(3)]

        def tokens():
            fam = families[rng.randint(3)]
            head = fam[:rng.randint(2, 7)]
            return head + [int(t) for t in rng.randint(50, 64, rng.randint(0, 3))]

        pinned = []
        for step in range(1, 400):
            op = rng.randint(7)
            if op <= 1:
                keep = rng.rand() < 0.2
                if twin.park(tokens(), step, release=not keep) is not None and keep:
                    pinned.append(twin.pairs[-1])
            elif op == 2:
                toks = tokens()
                (je, juse, jraw), (te, tuse, traw) = twin.call("match", toks, min_use=twin.w)
                assert (_view(te), tuse, traw) == (_view(je), juse, jraw)
                if te is not None and rng.rand() < 0.5:
                    twin.call_pair("acquire", je, te)
                    twin.pairs.append((je, te))
                    pinned.append((je, te))
            elif op == 3:
                toks = tokens()
                assert twin.tc.peek(toks, min_use=twin.w) == twin.jc.peek(toks, min_use=twin.w)
            elif op == 4 and pinned:
                twin.call_pair("release", *pinned.pop(rng.randint(len(pinned))))
            elif op == 5:
                want, got = twin.call("evict_one", current_step=step)
                assert got == want
            else:
                want, got = twin.call("evict_entry")
                assert got == want
            twin.check(step)
        stats = twin.tc.stats()
        assert stats["trimmed_blocks"] > 0 and stats["evictions"] > 0 and stats["hits"] > 0

    def test_trim_to_death_and_reextension(self):
        """The block-granular LRU's two edges, in lockstep: an entry
        trimmed block by block below one window dies; a trimmed entry
        re-extends when its full run is parked again."""
        twin = _Twin(nb=12, max_entries=4)
        twin.park([1, 2, 3, 4, 5, 6], step=1)
        twin.park([9, 8, 7, 6], step=50)
        for step in (60, 61):  # the coldest tails: both of [1..6]'s
            assert twin.call("evict_one", current_step=step) == (True, True)
            twin.check(step)
        assert [e["length"] for e in twin.tc.export_blocks()] == [2, 4]
        twin.park([1, 2, 3, 4, 5, 6], step=70)  # the full run again
        twin.check(70)
        assert twin.reextended == 1
        assert [e["length"] for e in twin.tc.export_blocks()] == [6, 4]
        while True:
            want, got = twin.call("evict_one", current_step=80)
            assert got == want
            twin.check(80)
            if not got:
                break
        assert twin.tc.resident == 0 and twin.tc.evictions == twin.jc.evictions >= 2

    def test_pinned_entry_never_trimmed_and_cap_evicts_whole(self):
        twin = _Twin(nb=12, max_entries=1)
        twin.park([1, 2, 3, 4], step=1, release=False)
        assert twin.call("evict_one") == (False, False)
        twin.check(1)
        twin.call_pair("release", *twin.pairs[-1])
        twin.park([7, 7, 7, 7], step=2)  # at the cap: the first dies whole
        twin.check(2)
        assert twin.tc.evictions == 1 and twin.tc.resident == 1


# -- the block primitives --------------------------------------------------
def _pools(cfg, nb, w, int8, seed):
    """The same pool for both frameworks: random bf16 values, or those
    quantized by the reference."""
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, nb, w, cfg.n_heads, cfg.d_head)
    jpool = {n: jnp.asarray(rng.randn(*shape), jnp.bfloat16) for n in ("k", "v")}
    if int8:
        jpool = {n: jq.quantize_tensor(a.astype(jnp.float32), (4,)) for n, a in jpool.items()}
    return jpool, jax.tree_util.tree_map(_to_torch, jpool)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _assert_trees_equal(ttree, jtree):
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves = jax.tree_util.tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
        assert tuple(t.shape) == j.shape


class TestBlockPrimitives:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_read_write_copy_match_reference_bitwise(self, int8):
        jcfg, tcfg = CONFIGS["dense"]
        jpool, tpool = _pools(jcfg, 6, 4, int8, seed=11)
        _assert_trees_equal(tp.read_block(tpool, 3), jp.read_block(jpool, jnp.int32(3)))
        data_j = jp.read_block(jpool, jnp.int32(2))
        data_t = tp.read_block(tpool, 2)
        jpool = jp.write_block(jpool, jnp.int32(5), data_j)
        assert tp.write_block(tpool, 5, data_t) is tpool  # in place
        _assert_trees_equal(tpool, jpool)
        jpool = jp.copy_block(jpool, jnp.int32(1), jnp.int32(4))
        assert tp.copy_block(tpool, 1, 4) is tpool
        _assert_trees_equal(tpool, jpool)

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_payload_is_a_copy(self, int8):
        """A stored payload does not change when its block is rewritten,
        and writing it into another block restores the bytes it had."""
        _, tpool = _pools(CONFIGS["dense"][0], 6, 4, int8, seed=12)
        data = tp.read_block(tpool, 2)
        before = jax.tree_util.tree_map(torch.clone, data)
        tp.copy_block(tpool, 2, 3)  # block 2 reallocated and rewritten
        tp.write_block(tpool, 4, data)
        leaves = jax.tree_util.tree_leaves
        for a, b, c in zip(leaves(data), leaves(before), leaves(tp.read_block(tpool, 4))):
            assert torch.equal(a, b) and torch.equal(c, b)


# -- the engine with the cache ---------------------------------------------
SHARED = [5, 9, 2, 7, 11, 3]  # test_paged's shared system prompt
STREAM = (
    [(SHARED + [t], 4, 0) for t in (1, 2, 3, 4, 5)]
    + [(SHARED[:3] + [20, t], 3, 0) for t in (6, 7)]
    + [([8, 8], 2, 0)]
)


def _pressure_stream(vocab):
    """test_paged's eviction stream: four 5-token families, 16 requests."""
    rng = np.random.RandomState(1)
    families = [[int(x) for x in rng.randint(0, vocab, 5)] for _ in range(4)]
    return [(families[i % 4] + [int(rng.randint(0, vocab))], int(rng.randint(1, 5)), 0)
            for i in range(16)]


def _engines(jparams, tparams, jcfg, tcfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prompt_slots", 8)
    kw.setdefault("max_new_cap", 5)
    return (settled(JaxEngine(jparams, jcfg, attn_backend="gather", **kw)),
            ServeEngine(tparams, tcfg, device="cpu", **kw))


class TestEngineWithCache:
    def test_shared_prefix_stream_matches_reference(self, dense):
        """Aliasing, parking and the partial-block COW running: every
        counter equal after every tick, prefix reuse per request equal."""
        jcfg, tcfg, jparams, tparams = dense
        jeng, teng = _engines(jparams, tparams, jcfg, tcfg, prefix_cache_slots=8)
        jdone, tdone = lockstep(jeng, teng, STREAM)
        assert_requests_match(jcfg, jparams, STREAM, jdone, tdone)
        kv, pf = teng.kv_block_stats, teng.prefix_stats
        assert kv["alias_blocks_total"] > 0 and kv["cow_blocks_total"] > 0
        assert pf["hits"] >= 5 and pf["prefill_tokens_reused"] > 0
        assert [t.prefix_reused for t in tdone][1:5] == [6] * 4

    def test_eviction_under_block_pressure_matches_reference(self, dense):
        jcfg, tcfg, jparams, tparams = dense
        reqs = _pressure_stream(jcfg.vocab)
        jeng, teng = _engines(jparams, tparams, jcfg, tcfg, slots=3, prefix_cache_slots=4,
                              kv_blocks=24)
        jdone, tdone = lockstep(jeng, teng, reqs)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        pf = teng.prefix_stats
        assert pf["evictions"] > 0 and pf["hits"] > 0
        held = {b for e in teng._prefix.export_blocks() for b in e["blocks"]}
        assert teng.kv_block_stats["blocks_allocated"] == len(held)

    def test_int8_pool_matches_reference(self):
        """The same stream with int8 weights and an int8 pool: the COW
        copies both leaves of each pair."""
        jcfg, tcfg = CONFIGS["dense"]
        jparams, tparams = both_params(jcfg, quantized=True)
        jeng, teng = _engines(jparams, tparams, jcfg, tcfg, prefix_cache_slots=8, kv_int8=True)
        jdone, tdone = lockstep(jeng, teng, STREAM)
        assert_requests_match(jcfg, jparams, STREAM, jdone, tdone, kv_int8=True)
        assert teng.kv_block_stats["cow_blocks_total"] > 0

    def test_cache_off_equals_cache_on(self, dense):
        """The port's own contract: the cache changes admission cost,
        never tokens."""
        jcfg, tcfg, _, tparams = dense
        out = {}
        for slots in (0, 8):
            eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=5,
                              prefix_cache_slots=slots, device="cpu")
            ids = [eng.submit(p, b) for p, b, _ in STREAM]
            eng.run()
            out[slots] = [eng.request(i).tokens for i in ids]
        assert out[0] == out[8]

    def test_opt_out_neither_reuses_nor_parks(self, dense):
        _, tcfg, _, tparams = dense
        eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=5,
                          prefix_cache_slots=8, device="cpu")
        eng.submit(SHARED + [1], 2)
        eng.run()
        rid = eng.submit(SHARED + [2], 2, use_prefix_cache=False)
        eng.run()
        assert eng.request(rid).prefix_reused == 0
        assert eng.prefix_stats["resident"] == 1 and eng.peek_prefix(SHARED + [2]) == 6

    def test_shared_blocks_are_never_written(self, dense):
        """Snapshot every block with more than one owner after admission;
        after the decode steps their bytes are unchanged, and the table
        cells decode writes are private."""
        _, tcfg, _, tparams = dense
        eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=5,
                          prefix_cache_slots=8, device="cpu")
        eng.submit(SHARED + [1], 5)
        eng.tick()
        eng.submit(SHARED + [2], 5)
        eng.tick()  # the second aliases the first's windows
        shared = [b for b in range(1, eng._balloc.num_blocks) if eng._balloc.refcount(b) > 1]
        assert shared
        snap = {b: tp.read_block(eng._pool, b) for b in shared}
        length, w = len(SHARED) + 1, eng.block_size
        for row in range(2):
            for col, blk in enumerate(eng._table[row]):
                if blk and col >= length // w:
                    assert eng._balloc.refcount(int(blk)) == 1, (row, col, blk)
        eng.run()
        for b, data in snap.items():
            for a, c in zip(jax.tree_util.tree_leaves(tp.read_block(eng._pool, b)),
                            jax.tree_util.tree_leaves(data)):
                assert torch.equal(a, c), b
        assert eng.kv_block_stats["cow_blocks_total"] == 2

    def test_pool_sizing_and_knobs_follow_the_reference(self, dense):
        jcfg, tcfg, jparams, tparams = dense
        jeng, teng = _engines(jparams, tparams, jcfg, tcfg, slots=3, prefix_cache_slots=4)
        assert teng.kv_block_stats["blocks_total"] == jeng.kv_block_stats["blocks_total"]
        assert teng.kv_block_stats["host_capacity"] == jeng.kv_block_stats["host_capacity"]
        assert reference_prefix_stats(teng.prefix_stats) == jeng.prefix_stats
        with pytest.raises(ValueError, match="prefix_cache_slots"):
            ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=2,
                        prefix_cache_slots=-1, device="cpu")
        # The floor grows by the COW block with a cache: 5 columns + 1 + 1.
        with pytest.raises(ValueError, match="kv_blocks must be >= 7"):
            ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=2, prefix_window=2,
                        prefix_cache_slots=1, kv_blocks=6, device="cpu")


# -- the kernel route over aliased tables ----------------------------------
# Three rows whose tables start with the same two blocks and then diverge;
# every row's position lies past the shared blocks, so the step writes
# only private blocks.
ALIASED_TABLE = np.array([[1, 2, 3, 0], [1, 2, 4, 5], [1, 2, 6, 0]], np.int32)
ALIASED_POS = np.array([9, 15, 8], np.int32)


class TestKernelRouteOverAliasedTables:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_step_matches_gather_and_reference_kernel(self, int8):
        jcfg, tcfg = CONFIGS["dense"]
        jparams, tparams = both_params(jcfg, quantized=int8)
        tok = np.array([3, 9, 60], np.int32)
        jpool, _ = _pools(jcfg, 8, 4, int8, seed=13)
        want, _ = jp.paged_decode_step_rows(
            jparams, jnp.asarray(tok), jpool, jnp.asarray(ALIASED_TABLE),
            jnp.asarray(ALIASED_POS), jcfg, backend="pallas",
        )
        out = {}
        for backend in ("gather", "cuda"):
            _, tpool = _pools(jcfg, 8, 4, int8, seed=13)
            out[backend], _ = tp.paged_decode_step_rows(
                tparams, torch.tensor(tok), tpool, torch.tensor(ALIASED_TABLE),
                torch.tensor(ALIASED_POS), tcfg, backend=backend,
            )
        assert_logits_close(out["cuda"].numpy(), np.asarray(want))
        assert_logits_close(out["cuda"].numpy(), out["gather"].numpy())

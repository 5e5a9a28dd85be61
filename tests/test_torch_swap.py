"""The port's host swap tier (tpu_dra_torch/parallel/swap.py and the
engine's preemption in serve.py) against the reference
(tpu_dra/parallel/swap.py, serve.py) on the reference's weights.

- `HostBlockPool` and `AgeHeatPolicy` are driven with the reference's on
  the same operations and candidates: every return value and state equal.
- The port's engine and the reference's serve the same streams tick by
  tick (test_torch_prefix.lockstep: block and prefix counters equal after
  every tick, the port's blocks and host slots conserved between ticks):
  a preemption round trip, a park-only host tier, equal priorities,
  priority order, a trimmed entry re-extending, pins released at
  swap-out, and a seeded priority churn.  Tokens equal the reference's up
  to a reference near-tie (test_torch_prefix.assert_same_tokens), and a
  preempted request's tokens equal those of the same request never
  preempted.  Two engines pick victims by wall-clock block ages under
  `AgeHeatPolicy`; where more than one row can be preempted, both run the
  deterministic `LowestPriority` policy, so that their schedules agree."""

import numpy as np
import pytest
import torch

from test_torch_prefix import assert_requests_match, dense, lockstep, settled  # noqa: F401
from tpu_dra.parallel import swap as jswap
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import swap as tswap
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)

LONG = [5, 9, 2, 7, 11, 3]
SHORT = [1, 2, 3]


class LowestPriority:
    """Victim: the lowest-priority candidate, the lowest row among equals."""

    def pick(self, candidates, *, free_blocks, num_blocks):
        if not candidates:
            return None
        return min(candidates, key=lambda c: (c["priority"], c["row"]))["row"]


def _engines(dense, **kw):
    """Both engines, floor-sized by default: one worst-case request
    (ceil((8 + 5) / 2) = 7 columns) + scratch = 8 blocks."""
    jcfg, tcfg, jparams, tparams = dense
    kw.setdefault("slots", 2)
    kw.setdefault("prompt_slots", 8)
    kw.setdefault("max_new_cap", 5)
    kw.setdefault("prefix_window", 2)
    kw.setdefault("kv_blocks", 8)
    return (settled(JaxEngine(jparams, jcfg, attn_backend="gather", **kw)),
            ServeEngine(tparams, tcfg, device="cpu", **kw))


def _uncontended(dense, prompt, budget):
    _, tcfg, _, tparams = dense
    eng = ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=5, prefix_window=2,
                      device="cpu")
    rid = eng.submit(prompt, budget)
    eng.run()
    return eng.request(rid).tokens


# -- host-side twins -------------------------------------------------------
class TestHostBlockPoolTwin:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_seeded_operations_match_reference(self, seed):
        rng = np.random.RandomState(seed)
        ref, port = jswap.HostBlockPool(5), tswap.HostBlockPool(5)
        for i in range(200):
            owned = port.used_slots()
            if owned and rng.rand() < 0.45:
                slot = owned[rng.randint(len(owned))]
                assert port.load(slot) == ref.load(slot)
                port.free(slot)
                ref.free(slot)
            else:
                assert port.store(("payload", i)) == ref.store(("payload", i))
            assert port.used_slots() == ref.used_slots()
            assert port.stats() == ref.stats()
            assert (port.free_count, port.used_count) == (ref.free_count, ref.used_count)

    @pytest.mark.parametrize("mod", [jswap, tswap], ids=["reference", "port"])
    def test_misuse_raises(self, mod):
        pool = mod.HostBlockPool(1)
        with pytest.raises(RuntimeError, match="unowned"):
            pool.load(0)
        slot = pool.store("x")
        pool.free(slot)
        with pytest.raises(RuntimeError, match="unowned"):
            pool.free(slot)
        assert mod.HostBlockPool(0).store("x") is None
        with pytest.raises(ValueError, match="capacity"):
            mod.HostBlockPool(-1)


def _rec(block, *, age_s, idle, ref=1):
    return {"block": block, "refcount": ref, "age_s": age_s, "idle_steps": idle,
            "origin": "computed", "birth_step": 0, "last_touch_step": 0, "owners": []}


def _cand(row, blocks, records, priority=0):
    return {"row": row, "priority": priority, "blocks": blocks, "records": records}


# test_swap.py's hand-built cases: (candidates, free blocks, defrag weight,
# the reference's pick).
POLICY_CASES = {
    "cold_old_beats_hot_young": (
        [_cand(0, [1], {1: _rec(1, age_s=100.0, idle=500)}),
         _cand(1, [2], {2: _rec(2, age_s=0.1, idle=0)})], set(), 1.0, 0),
    "defrag_breaks_near_ties": (
        [_cand(0, [6], {6: _rec(6, age_s=10.0, idle=10)}),
         _cand(1, [3], {3: _rec(3, age_s=10.0, idle=10)})], {2, 4}, 10.0, 1),
    "shared_blocks_earn_no_defrag_credit": (
        [_cand(0, [5], {5: _rec(5, age_s=10.0, idle=10, ref=2)}),
         _cand(1, [3], {3: _rec(3, age_s=10.0, idle=10)})], {2, 4}, 10.0, 1),
    "no_candidate_declines": ([], set(), 1.0, None),
}


class TestAgeHeatPolicyTwin:
    @pytest.mark.parametrize("name", sorted(POLICY_CASES))
    def test_hand_built_cases(self, name):
        cands, free, weight, want = POLICY_CASES[name]
        kw = dict(free_blocks=free, num_blocks=8)
        assert tswap.AgeHeatPolicy(weight).pick(cands, **kw) == want
        assert jswap.AgeHeatPolicy(weight).pick(cands, **kw) == want

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_candidates_match_reference(self, seed):
        rng = np.random.RandomState(seed)
        nb = 24
        for _ in range(50):
            blocks = list(rng.permutation(np.arange(1, nb))[:rng.randint(2, 16)])
            records = {int(b): _rec(int(b), age_s=float(rng.choice([1.0, 2.0, 5.0])),
                                    idle=int(rng.randint(3)), ref=int(rng.randint(1, 3)))
                       for b in blocks}
            cands, used = [], 0
            for row in range(rng.randint(0, 5)):
                n = int(rng.randint(1, 4))
                cands.append(_cand(row, [int(b) for b in blocks[used:used + n]], records))
                used += n
            free = {int(b) for b in range(1, nb) if b not in records and rng.rand() < 0.5}
            weight = float(rng.choice([0.0, 1.0, 10.0]))
            kw = dict(free_blocks=free, num_blocks=nb)
            assert (tswap.AgeHeatPolicy(weight).pick(cands, **kw)
                    == jswap.AgeHeatPolicy(weight).pick(cands, **kw))

    def test_negative_weight_rejected(self):
        with pytest.raises(ValueError, match="defrag_weight"):
            tswap.AgeHeatPolicy(defrag_weight=-1.0)


# -- the engine --------------------------------------------------------------
class TestPreemption:
    def test_preempt_round_trip_matches_reference_and_uncontended(self, dense):
        jcfg, _, jparams, _ = dense
        reqs = [(LONG, 5, 0, 0), (SHORT, 5, 5, 1)]
        jeng, teng = _engines(dense)
        jdone, tdone = lockstep(jeng, teng, reqs)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        v, p = tdone
        assert v.preemptions == 1 and v.preempted_by == [p.id]
        assert v.swap_in_blocks == v.swap_out_blocks > 0
        assert v.swapped_s > 0 and not v.swapped
        # The parked stall is counted once, in swapped_s, not in the gaps.
        assert sum(v.token_deltas) + v.swapped_s <= v.finished_at - v.first_token_at + 1e-6
        assert v.tokens == _uncontended(dense, LONG, 5)
        assert p.tokens == _uncontended(dense, SHORT, 5)
        stats = teng.kv_block_stats
        assert stats["preemptions_total"] == 1 and stats["blocks_host"] == 0
        assert stats["swap_in_blocks_total"] == stats["swap_out_blocks_total"] == v.swap_out_blocks

    @pytest.mark.parametrize("case", ["host_tier_off", "equal_priority"])
    def test_parks_instead_of_preempting(self, dense, case):
        """No host tier, or a head of the victim's own priority: the head
        parks and the row keeps decoding."""
        jcfg, _, jparams, _ = dense
        prio = 0 if case == "equal_priority" else 5
        kw = {"host_kv_blocks": 0} if case == "host_tier_off" else {}
        reqs = [(LONG, 5, 0, 0), (SHORT, 5, prio, 1)]
        jeng, teng = _engines(dense, **kw)

        def parked(jeng, teng):
            if teng.occupancy == 1:
                assert teng.request(0).preemptions == 0

        jdone, tdone = lockstep(jeng, teng, reqs, between=parked)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        assert teng.kv_block_stats["preemptions_total"] == 0

    def test_priority_orders_admission_fifo_within_class(self, dense):
        jcfg, _, jparams, _ = dense
        reqs = [([1, 2], 2, 0), ([3, 4], 2, 0), ([5, 6], 2, 7), ([7, 8], 2, 7)]
        jeng, teng = _engines(dense, slots=1, max_new_cap=2, kv_blocks=None)
        jdone, tdone = lockstep(jeng, teng, reqs)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        order = [r.id for r in teng._done]
        assert order == [r.id for r in jeng._done] == [2, 3, 0, 1]

    def test_trimmed_entry_reextends_through_admission(self, dense):
        jcfg, _, jparams, _ = dense
        jeng, teng = _engines(dense, prefix_cache_slots=4, kv_blocks=None)
        lockstep(jeng, teng, [(LONG, 5, 0)])
        for eng in (jeng, teng):
            assert eng._prefix.evict_one(current_step=eng.device_steps)
        assert [e["length"] for e in teng._prefix.export_blocks()] == [4]
        jdone, tdone = lockstep(jeng, teng, [(LONG, 5, 0)])
        assert_requests_match(jcfg, jparams, [(LONG, 5, 0)], jdone, tdone)
        assert tdone[0].prefix_reused == 4  # aliased the stub
        assert [e["length"] for e in teng._prefix.export_blocks()] == [6]

    def test_preemption_releases_prefix_pins(self, dense):
        jcfg, _, jparams, _ = dense
        reqs = [(LONG, 5, 0, 0), (SHORT + [4, 5, 6], 5, 5, 1)]
        jeng, teng = _engines(dense, prefix_cache_slots=2, kv_blocks=12)
        jdone, tdone = lockstep(jeng, teng, reqs)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        assert tdone[0].preemptions >= 1
        assert tdone[0].tokens == _uncontended(dense, LONG, 5)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_seeded_priority_churn_matches_reference(self, dense, seed):
        """One arrival a tick, priorities 0, 1, 2 in turn, prompts from two
        families: hits, trims, evictions and preemptions all happen."""
        jcfg, _, jparams, _ = dense
        rng = np.random.RandomState(seed)
        fams = [[int(t) for t in rng.randint(0, jcfg.vocab, 4)] for _ in range(2)]
        reqs = [(fams[i % 2][:rng.randint(2, 5)]
                 + [int(t) for t in rng.randint(0, jcfg.vocab, rng.randint(1, 4))],
                 2 + i % 3, i % 3, i) for i in range(12)]
        jeng, teng = _engines(dense, max_new_cap=4, prefix_cache_slots=2, kv_blocks=10,
                              swap_policy=LowestPriority())
        jdone, tdone = lockstep(jeng, teng, reqs)
        assert_requests_match(jcfg, jparams, reqs, jdone, tdone)
        assert teng.kv_block_stats["preemptions_total"] > 0
        assert teng.kv_block_stats["blocks_host"] == 0
        assert teng.prefix_stats["hits"] > 0 and teng.prefix_stats["trimmed_blocks"] > 0

    def test_knobs_validated(self, dense):
        _, tcfg, _, tparams = dense
        with pytest.raises(ValueError, match="host_kv_blocks"):
            ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=2,
                        host_kv_blocks=-1, device="cpu")
        eng = ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=2, device="cpu")
        for bad in (True, 2 ** 40, 1.0):
            with pytest.raises(ValueError, match="priority"):
                eng.submit(SHORT, 2, priority=bad)
        assert eng.queue_depth == 0

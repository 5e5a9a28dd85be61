"""The port's serving engine (tpu_dra_torch/parallel/serve.py) against the
reference's (tpu_dra/parallel/serve.py, paged layout, gather backend) on
the reference's weights: one stream of more requests than slots, with eos
and budget finishes, must give identical greedy tokens and finish
reasons; blocks are conserved; the device and backend rules hold."""

import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)

# (slots, prompt_slots, max_new_cap): a small engine, and one whose
# longest request fills the whole context (prompt_slots + max_new_cap ==
# seq == 32), so the last write lands in the table's last slot.
ENGINES = {"small": (3, 8, 6), "full_context": (2, 16, 16)}


def _stream(vocab, prompt_slots, max_new_cap, n, seed):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        length = prompt_slots if i == 0 else int(rng.randint(1, prompt_slots + 1))
        budget = max_new_cap if i == 0 else int(rng.randint(1, max_new_cap + 1))
        reqs.append(([int(t) for t in rng.randint(0, vocab, length)], budget))
    return reqs


def _drain(eng, reqs):
    ids = [eng.submit(p, b) for p, b in reqs]
    done = {r.id: r for r in eng.run()}
    return [(done[i].tokens, done[i].finish_reason) for i in ids]


class TestEngineParity:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    @pytest.mark.parametrize("shape", sorted(ENGINES))
    def test_stream_tokens_and_finishes_identical(self, name, shape):
        jcfg, tcfg = CONFIGS[name]
        jparams, tparams = both_params(jcfg)
        slots, prompt_slots, cap = ENGINES[shape]
        reqs = _stream(jcfg.vocab, prompt_slots, cap, 2 * slots + 1, seed=7)
        # The eos: the reference's most frequent generated token, so the
        # stream has both eos and budget finishes.
        plain = _drain(
            JaxEngine(jparams, jcfg, slots=slots, prompt_slots=prompt_slots,
                      max_new_cap=cap, attn_backend="gather"),
            reqs,
        )
        eos = int(np.bincount([t for toks, _ in plain for t in toks[1:]]).argmax())
        want = _drain(
            JaxEngine(jparams, jcfg, slots=slots, prompt_slots=prompt_slots,
                      max_new_cap=cap, eos_token=eos, attn_backend="gather"),
            reqs,
        )
        eng = ServeEngine(tparams, tcfg, slots=slots, prompt_slots=prompt_slots,
                          max_new_cap=cap, eos_token=eos, device="cpu")
        got = _drain(eng, reqs)
        assert got == want
        reasons = {reason for _, reason in want}
        assert reasons == {"eos", "budget"}
        # Blocks are conserved: everything back on the free list.
        stats = eng.kv_stats()
        assert stats["blocks_free"] == stats["blocks_total"] - 1
        assert stats["blocks_allocated"] == 0
        assert not eng._table.any()

    def test_steps_per_tick_changes_no_token(self):
        jcfg, tcfg = CONFIGS["dense"]
        _, tparams = both_params(jcfg)
        reqs = _stream(jcfg.vocab, 8, 5, 5, seed=8)
        out = {}
        for spt in (1, 3):
            eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=5,
                              steps_per_tick=spt, device="cpu")
            out[spt] = _drain(eng, reqs)
        assert out[1] == out[3]


class TestEngineRules:
    def _params(self):
        return both_params(CONFIGS["dense"][0])[1]

    def test_no_device_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA: the default device is valid")
        with pytest.raises(RuntimeError, match="no CUDA"):
            ServeEngine(self._params(), CONFIGS["dense"][1], slots=2, prompt_slots=8,
                        max_new_cap=4)

    def test_backends_on_a_cpu_engine(self):
        params, cfg = self._params(), CONFIGS["dense"][1]
        eng = ServeEngine(params, cfg, slots=2, prompt_slots=8, max_new_cap=4, device="cpu")
        assert eng.attn_backend == "gather"
        with pytest.raises(ValueError, match="CUDA engine"):
            ServeEngine(params, cfg, slots=2, prompt_slots=8, max_new_cap=4,
                        attn_backend="cuda", device="cpu")
        with pytest.raises(ValueError, match="attn_backend"):
            ServeEngine(params, cfg, slots=2, prompt_slots=8, max_new_cap=4,
                        attn_backend="pallas", device="cpu")

    def test_pool_sizing_follows_the_reference(self):
        params, cfg = self._params(), CONFIGS["dense"][1]
        eng = ServeEngine(params, cfg, slots=3, prompt_slots=8, max_new_cap=6, device="cpu")
        ref = JaxEngine(both_params(CONFIGS["dense"][0])[0], CONFIGS["dense"][0],
                        slots=3, prompt_slots=8, max_new_cap=6)
        assert eng.block_size == ref._block_size
        assert eng.kv_stats()["blocks_total"] == ref._balloc.num_blocks
        with pytest.raises(ValueError, match="kv_blocks"):
            ServeEngine(params, cfg, slots=3, prompt_slots=8, max_new_cap=6,
                        kv_blocks=7, device="cpu")

    def test_block_gate_queues_instead_of_overcommitting(self):
        """A pool with room for one worst-case request admits one at a
        time, whatever the free slots."""
        params, cfg = self._params(), CONFIGS["dense"][1]
        eng = ServeEngine(params, cfg, slots=3, prompt_slots=8, max_new_cap=6,
                          kv_blocks=8, device="cpu")
        for _ in range(3):
            eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 6)
        eng.tick()
        assert eng.queued == 2
        assert sum(r is not None for r in eng._row_req) == 1
        assert len(eng.run()) == 3 and eng.kv_stats()["blocks_free"] == 7

    @pytest.mark.parametrize(
        "prompt,budget,match",
        [([], 2, "prompt length"), (list(range(9)), 2, "prompt length"),
         ([64], 2, "token ids"), ([True], 2, "token ids"), ([1], 7, "max_new")],
    )
    def test_bad_submit_rejected(self, prompt, budget, match):
        eng = ServeEngine(self._params(), CONFIGS["dense"][1], slots=2, prompt_slots=8,
                          max_new_cap=6, device="cpu")
        with pytest.raises(ValueError, match=match):
            eng.submit(prompt, budget)

    def test_closed_engine_refuses_work(self):
        eng = ServeEngine(self._params(), CONFIGS["dense"][1], slots=2, prompt_slots=8,
                          max_new_cap=6, device="cpu")
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit([1], 1)
        with pytest.raises(RuntimeError, match="closed"):
            eng.tick()

"""The port's KV-cache decode (tpu_dra_torch/parallel/decode.py) against
the reference (tpu_dra/parallel/decode.py): per-row decode steps, step by
step, their greedy tokens, the pick and logprob helpers and the window
checks.  Tolerance as stated in test_torch_burnin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, assert_logits_close, both_params
from tpu_dra.parallel import decode as jd
from tpu_dra_torch.parallel import decode as td

torch.set_num_threads(2)


class TestDecodeStepRows:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_steps_match_reference_and_greedy_tokens_agree(self, name):
        """Rows at different positions step together from a zeroed cache,
        both fed the reference's greedy token at every step: the logits
        match at every step, the port's greedy pick equals the
        reference's wherever the reference is not at a near-tie, and the
        caches hold the same K/V."""
        jcfg, tcfg = CONFIGS[name]
        jparams, tparams = both_params(jcfg)
        jcache = jd.init_cache(jcfg, 3)
        tcache = td.init_cache(tcfg, 3, device="cpu")
        assert tcache["k"].dtype == torch.bfloat16
        assert tuple(tcache["k"].shape) == jcache["k"].shape
        base = np.array([0, 5, 11], np.int32)
        tok = np.random.RandomState(2).randint(0, jcfg.vocab, 3).astype(np.int32)
        for t in range(12):
            pos = base + t
            jl, jcache = jd.decode_step_rows(
                jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg
            )
            tl, tcache = td.decode_step_rows(
                tparams, torch.tensor(tok), tcache, torch.tensor(pos), tcfg
            )
            jl = np.asarray(jl)
            assert_logits_close(tl.numpy(), jl)  # includes the greedy picks
            tok = np.asarray(jd._make_pick(False, 0.0)(jnp.asarray(jl), None))
        for leaf in ("k", "v"):
            want = np.asarray(jcache[leaf], np.float32)
            np.testing.assert_allclose(
                tcache[leaf].float().numpy(), want,
                rtol=2 ** -6, atol=2 ** -6 * float(np.abs(want).max()),
            )

    def test_cache_is_written_in_place_at_row_positions(self):
        jcfg, tcfg = CONFIGS["dense"]
        _, tparams = both_params(jcfg)
        cache = td.init_cache(tcfg, 2, device="cpu")
        k_before = cache["k"]
        pos = torch.tensor([3, 7], dtype=torch.int32)
        _, out = td.decode_step_rows(tparams, torch.tensor([1, 2]), cache, pos, tcfg)
        assert out is cache and out["k"] is k_before
        written = cache["k"].abs().sum(dim=(0, 3, 4))  # (B, T)
        assert written[0, 3] > 0 and written[1, 7] > 0
        assert written.count_nonzero() == 2

    def test_per_row_write_rejects_multitoken(self):
        with pytest.raises(ValueError, match="single-token"):
            td._cache_update(
                torch.zeros((2, 8, 4, 8), dtype=torch.bfloat16),
                torch.zeros((2, 3, 4, 8)),
                torch.tensor([0, 1]),
            )


class TestHelpers:
    def test_greedy_pick_and_chosen_logprob_match(self):
        rng = np.random.RandomState(3)
        logits = rng.randn(4, 64).astype(np.float32) * 3
        logits[2, [5, 9]] = 10.0  # a tie: both take the first maximum
        want_tok = np.asarray(jd._make_pick(False, 0.0)(jnp.asarray(logits), None))
        got_tok = td._make_pick(False)(torch.tensor(logits))
        assert got_tok.dtype == torch.int32
        np.testing.assert_array_equal(got_tok.numpy(), want_tok)
        want_lp = np.asarray(jd._chosen_logprob(jnp.asarray(logits), jnp.asarray(want_tok)))
        got_lp = td._chosen_logprob(torch.tensor(logits), got_tok)
        np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-6, atol=1e-6)

    def test_sampling_rejected(self):
        with pytest.raises(ValueError, match="greedy"):
            td._make_pick(True)

    @pytest.mark.parametrize(
        "first,steps",
        [(0, 4), (32, 1), (30, 0), (30, 3), (31, 1)],
    )
    def test_check_window_matches_reference(self, first, steps):
        jcfg, tcfg = CONFIGS["dense"]
        outcome = []
        for fn, cfg in ((jd._check_window, jcfg), (td._check_window, tcfg)):
            try:
                fn(cfg, first, steps, "prompt_slots")
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]

    @pytest.mark.parametrize("window", [0, 3, 4, 8, 9])
    def test_check_prefix_window_matches_reference(self, window):
        jcfg, tcfg = CONFIGS["dense"]
        outcome = []
        for fn, cfg in ((jd._check_prefix_window, jcfg), (td._check_prefix_window, tcfg)):
            try:
                fn(cfg, 8, window)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]

    def test_embed_lookup_takes_float_tables_only(self):
        emb = torch.randn(10, 4)
        idx = torch.tensor([3, 0, 9], dtype=torch.int32)
        assert torch.equal(td._embed_lookup(emb, idx), emb[idx.long()])
        with pytest.raises(TypeError, match="int8"):
            td._embed_lookup({"q": emb, "s": emb}, idx)

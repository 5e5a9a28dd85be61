"""The port's sampling policy and generation factories
(tpu_dra_torch/parallel/decode.py: `filter_logits`, `_make_pick`,
`_validate_filters`, `make_generate`, `make_generate_padded`) against the
reference (tpu_dra/parallel/decode.py) on the reference's weights, with
the same keys: the port's Threefry is JAX's bit for bit
(test_torch_prng), so sampled tokens are compared token for token.

Tolerances:
- `filter_logits`: the same keep mask, except where a token's top-p
  boundary mass (the probability strictly before it) is within 1e-6 of p
  (the two cumulative sums round in their own order).
- Picks on the same logits: equal, except where the perturbed logits
  ``logits / T + g`` of the two picks lie within the gumbel tolerance of
  test_torch_prng.
- Whole-model outputs: the port's logits are bf16 values within 2 bf16
  ulps of the reference row's largest logit (``tol = 2**-6 *
  max|logit|``, test_torch_burnin), not bitwise.  So tokens are equal up
  to the first divergence, which must be a near-tie of the reference's
  perturbed logits (``z[want] - z[got] <= 2 * tol / T``, greedy: ``T =
  1, g = 0``) or a token at the reference filter's boundary; a logprob,
  the chosen logit less the log-sum-exp, is within ``2 * tol`` of the
  reference's.  Exact agreement of logprobs (1e-5) holds on equal logits
  (test_torch_decode's helper test; the card's own check in
  chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from test_torch_prng import GUMBEL_RTOL
from tpu_dra.parallel import decode as jd
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import prng

torch.set_num_threads(2)

LOGIT_TOL = 2.0 ** -6  # of max|logit|: test_torch_burnin's logit tolerance
# Filters exercised throughout: top-k, top-p, both.
FILTERS = {"top_k": dict(top_k=20), "top_p": dict(top_p=0.9), "both": dict(top_k=20, top_p=0.9)}


# -- near-tie helpers shared by the sampled parity tests -------------------
def ref_logits(jcfg, jparams, seq, kv_int8=False):
    """The reference's logits (len(seq), vocab) f32 over ``seq`` from a
    fresh cache: row i predicts token i + 1."""
    logits, _ = jd.decode_forward(jparams, jnp.asarray([list(seq)], jnp.int32),
                                  jd.init_cache(jcfg, 1, kv_int8), 0, jcfg)
    return np.asarray(logits[0], np.float32)


def at_filter_edge(row, t, top_k, top_p, tok, tol) -> bool:
    """Whether the logit tolerance can move ``tok`` across the edge of
    the filter support of ``row / t``: its logit within 2 tol of the k-th
    largest, or its exclusive top-p mass within ``4 * tol / t`` of p
    (each probability moves by a factor of at most ``exp(2 * tol / t)``)."""
    if top_k is not None and abs(row[tok] - np.sort(row)[-top_k]) <= 2 * tol:
        return True
    if top_p is not None:
        order = list(np.argsort(-row, kind="stable"))
        p = np.exp((row[order] - row.max()) / t)
        p /= p.sum()
        rank = order.index(tok)
        if abs(float(p[:rank].sum()) - top_p) <= 4 * tol / t:
            return True
    return False


def assert_near_tie(row, g, got, want, temperature=0.0, top_k=None, top_p=None):
    """The port picked ``got`` where the reference picked ``want`` from
    its logits ``row`` (V,) and gumbel ``g`` (V,; ignored when greedy):
    a near-tie of the perturbed logits, or one of the two tokens at the
    edge of the filter's support."""
    tol = LOGIT_TOL * float(np.abs(row).max())
    t = temperature if temperature > 0 else 1.0
    z = row / t + (g if temperature > 0 else 0.0)
    if z[want] - z[got] <= 2 * tol / t + 2 * GUMBEL_RTOL * max(1.0, abs(z[want])):
        return
    assert temperature > 0, (got, want)
    assert any(at_filter_edge(row, t, top_k, top_p, tok, tol) for tok in (got, want)), (got, want)


def generated_rows(jcfg, jparams, prompts, generated, kv_int8=False):
    """``rows(i)``: the reference's logits (n, vocab) that picked each of
    the n tokens ``generated[i]`` after ``prompts[i]`` (one forward over
    the whole sequence; causal, so each row sees only its prefix)."""
    def rows(i):
        p = list(prompts[i])
        return ref_logits(jcfg, jparams, p + list(generated[i]), kv_int8)[len(p) - 1:-1]

    return rows


def assert_sequences_match(got, want, ref_rows, gumbel, temperature=0.0, top_k=None,
                           top_p=None, got_lp=None, want_lp=None):
    """Per sequence, tokens equal up to the first divergence, which is a
    near-tie; logprobs before it within 2 tol of the reference's.
    ``ref_rows(i)``: the reference's logits that picked each token of
    sequence ``i`` (`generated_rows`); ``gumbel(i, j)``: the reference's
    gumbel draw for token ``j`` of sequence ``i``."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = list(g), list(w)
        assert len(g) == len(w)
        first = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), len(g))
        if first == len(g) and got_lp is None:
            continue
        rows = ref_rows(i)
        if first < len(g):
            assert_near_tie(rows[first], gumbel(i, first) if temperature > 0 else None,
                            g[first], w[first], temperature, top_k, top_p)
        if got_lp is not None:
            for j in range(first):
                tol = 2 * LOGIT_TOL * float(np.abs(rows[j]).max())
                assert abs(got_lp[i][j] - want_lp[i][j]) <= tol, (i, j)


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = CONFIGS["dense"]
    jparams, tparams = both_params(jcfg)
    return jcfg, tcfg, jparams, tparams


class TestFilterLogits:
    @pytest.mark.parametrize("name", sorted(FILTERS))
    def test_keep_mask_matches_reference(self, name):
        rng = np.random.RandomState(4)
        logits = (rng.randn(6, 64) * 3).astype(np.float32)
        logits[1] = np.round(logits[1])  # many exact ties
        logits[2] = 0.0  # all tied
        want = np.asarray(jd.filter_logits(jnp.asarray(logits), **FILTERS[name]))
        got = td.filter_logits(torch.tensor(logits), **FILTERS[name]).numpy()
        unsure = np.zeros(logits.shape, bool)
        if "top_p" in FILTERS[name]:
            p = FILTERS[name]["top_p"]
            order = np.argsort(-logits, axis=-1, kind="stable")
            srt = np.take_along_axis(logits, order, -1)
            probs = np.exp(srt - srt.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            before = np.cumsum(probs, -1) - probs
            np.put_along_axis(unsure, order, np.abs(before - p) <= 1e-6, -1)
        np.testing.assert_array_equal(np.isfinite(got)[~unsure], np.isfinite(want)[~unsure])
        kept = np.isfinite(got)
        np.testing.assert_array_equal(got[kept], logits[kept])

    def test_ties_keep_index_order(self):
        """The stable sort: among equal logits the lower index ranks
        first, so top_k=1 keeps the token argmax picks."""
        logits = np.zeros((1, 16), np.float32)
        logits[0, [3, 7, 11]] = 2.0
        for k in (1, 2, 4):
            got = td.filter_logits(torch.tensor(logits), top_k=k).numpy()
            want = np.asarray(jd.filter_logits(jnp.asarray(logits), top_k=k))
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        assert np.flatnonzero(np.isfinite(td.filter_logits(torch.tensor(logits), top_k=1).numpy())
                              ).tolist() == [3]

    @pytest.mark.parametrize("kw", [dict(top_k=0), dict(top_k=65), dict(top_p=0.0),
                                    dict(top_p=1.5)])
    def test_errors_match_reference(self, kw):
        logits = np.zeros((1, 64), np.float32)
        with pytest.raises(ValueError) as want:
            jd.filter_logits(jnp.asarray(logits), **kw)
        with pytest.raises(ValueError) as got:
            td.filter_logits(torch.tensor(logits), **kw)
        assert str(got.value) == str(want.value)


class TestValidateFilters:
    @pytest.mark.parametrize("sampled,top_k,top_p", [
        (False, None, None), (False, 5, None), (False, None, 0.5), (True, 0, None),
        (True, 65, None), (True, None, 0.0), (True, None, 1.01), (True, 64, 1.0),
    ])
    def test_same_outcome_as_reference(self, sampled, top_k, top_p):
        outcome = []
        for fn in (jd._validate_filters, td._validate_filters):
            try:
                fn(64, sampled, top_k, top_p)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]


class TestPick:
    @pytest.mark.parametrize("name", ["none", *sorted(FILTERS)])
    def test_sampled_pick_matches_reference(self, name):
        """One key over the whole (B, V) batch, and one key a row (the
        engine's fold_in(key(seed), pos) keys), same tokens except at a
        near-tie of the perturbed logits."""
        kw = FILTERS.get(name, {})
        logits = (np.random.RandomState(6).randn(5, 64) * 2).astype(np.float32)
        jpick = jd._make_pick(True, 0.7, **kw)
        tpick = td._make_pick(True, 0.7, **kw)
        scaled = np.asarray(jd.filter_logits(jnp.asarray(logits / np.float32(0.7)), **kw)
                            if kw else logits / np.float32(0.7))
        seeds = np.array([1, -5, 9, 0, 2 ** 31 - 1], np.int32)
        pos = np.array([3, 3, 40, 1023, 7], np.int32)
        jkeys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(seeds, pos)
        cases = [
            (jax.random.PRNGKey(12), prng.key(12),
             np.asarray(jax.random.gumbel(jax.random.PRNGKey(12), logits.shape))),
            (jkeys, prng.fold_in(prng.key(torch.tensor(seeds)), torch.tensor(pos)),
             np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (64,)))(jkeys))),
        ]
        for jk, tk, g in cases:
            if jk.ndim == 2:
                want = np.asarray(jax.vmap(lambda k, r: jpick(r[None], k)[0])(jk, jnp.asarray(logits)))
            else:
                want = np.asarray(jpick(jnp.asarray(logits), jk))
            got = tpick(torch.tensor(logits), tk)
            assert got.dtype == torch.int32
            z = scaled + g
            for a, b, zr in zip(got.numpy(), want, z):
                if a != b:
                    assert abs(zr[a] - zr[b]) <= 2 * GUMBEL_RTOL * max(1.0, abs(zr[b]))

    def test_greedy_pick_ignores_the_key(self):
        logits = torch.randn(3, 64)
        pick = td._make_pick(False)
        assert torch.equal(pick(logits), pick(logits, prng.key(3)))


def _gen_case(jcfg, jparams, tcfg, tparams, prompt, kw, steps=10, key=7, jquant=None):
    """Both factories on the same prompt (and key when sampled): returns
    (port tokens, logprobs, health), (reference's) and the closures the
    near-tie check needs."""
    jfn = jd.make_generate(jcfg, prompt_len=prompt.shape[1], steps=steps, with_logprobs=True,
                           with_health=True, **kw)
    tfn = td.make_generate(tcfg, prompt_len=prompt.shape[1], steps=steps, with_logprobs=True,
                           with_health=True, **kw)
    sampled = kw.get("temperature", 0.0) > 0
    jargs = (jax.random.PRNGKey(key),) if sampled else ()
    targs = (prng.key(key),) if sampled else ()
    want = [np.asarray(a) for a in jfn(jparams, jnp.asarray(prompt), *jargs)]
    got = tfn(tparams, torch.tensor(prompt), *targs)
    got = [got[0].numpy(), got[1].numpy(), bool(got[2])]
    return got, want


class TestMakeGenerate:
    CASES = {
        "greedy": dict(),
        "sampled": dict(temperature=0.8),
        "filtered": dict(temperature=0.8, top_k=20, top_p=0.9),
        "chunked": dict(temperature=1.1, prefill_chunk=4),
        "kv_int8": dict(temperature=0.9, kv_int8=True),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_tokens_logprobs_and_health_match_reference(self, dense, case):
        jcfg, tcfg, jparams, tparams = dense
        kw = self.CASES[case]
        steps, P = 10, 8
        prompt = np.random.RandomState(5).randint(0, jcfg.vocab, (3, P)).astype(np.int32)
        got, want = _gen_case(jcfg, jparams, tcfg, tparams, prompt, kw, steps=steps)
        assert got[0].shape == want[0].shape == (3, P + steps)
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[0][:, :P], prompt)
        assert got[2] and bool(want[2])
        T = kw.get("temperature", 0.0)
        keys = jax.random.split(jax.random.PRNGKey(7), steps) if T else None
        kv_int8 = kw.get("kv_int8", False)

        def gumbel(i, j):
            return np.asarray(jax.random.gumbel(keys[j], (3, jcfg.vocab)))[i]

        rows = generated_rows(jcfg, jparams, prompt, want[0][:, P:], kv_int8)
        assert_sequences_match(got[0][:, P:], want[0][:, P:], rows, gumbel, T, kw.get("top_k"),
                               kw.get("top_p"), got[1], want[1])

    def test_output_ordering_and_single_step(self, dense):
        jcfg, tcfg, _, tparams = dense
        prompt = torch.zeros((2, 4), dtype=torch.int32)
        only = td.make_generate(tcfg, prompt_len=4, steps=1)(tparams, prompt)
        assert torch.is_tensor(only) and only.shape == (2, 5)
        toks, ok = td.make_generate(tcfg, prompt_len=4, steps=3, with_health=True)(tparams, prompt)
        assert toks.shape == (2, 7) and ok.dtype == torch.bool
        toks, lps = td.make_generate(tcfg, prompt_len=4, steps=3, with_logprobs=True)(tparams, prompt)
        assert lps.shape == (2, 3) and bool((lps <= 0).all())

    def test_int8_weights_match_reference(self):
        jcfg, tcfg = CONFIGS["dense"]
        jparams, tparams = both_params(jcfg, quantized=True)
        prompt = np.random.RandomState(8).randint(0, jcfg.vocab, (2, 6)).astype(np.int32)
        got, want = _gen_case(jcfg, jparams, tcfg, tparams, prompt, dict(temperature=0.8),
                              steps=6)
        keys = jax.random.split(jax.random.PRNGKey(7), 6)
        assert_sequences_match(
            got[0][:, 6:], want[0][:, 6:], generated_rows(jcfg, jparams, prompt, want[0][:, 6:]),
            lambda i, j: np.asarray(jax.random.gumbel(keys[j], (2, jcfg.vocab)))[i], 0.8)

    def test_rope_greedy_matches_reference(self):
        jcfg, tcfg = CONFIGS["rope"]
        jparams, tparams = both_params(jcfg)
        prompt = np.random.RandomState(9).randint(0, jcfg.vocab, (2, 8)).astype(np.int32)
        got, want = _gen_case(jcfg, jparams, tcfg, tparams, prompt, dict(), steps=8)
        assert_sequences_match(got[0][:, 8:], want[0][:, 8:],
                               generated_rows(jcfg, jparams, prompt, want[0][:, 8:]), None)

    def test_errors_match_reference(self, dense):
        jcfg, tcfg, _, tparams = dense
        for kw in (dict(prompt_len=0, steps=4), dict(prompt_len=30, steps=3),
                   dict(prompt_len=8, steps=4, prefill_chunk=3),
                   dict(prompt_len=8, steps=4, top_k=5)):
            with pytest.raises(ValueError) as want:
                jd.make_generate(jcfg, **kw)
            with pytest.raises(ValueError) as got:
                td.make_generate(tcfg, **kw)
            assert str(got.value) == str(want.value)
        fn = td.make_generate(tcfg, prompt_len=4, steps=2, temperature=0.5)
        with pytest.raises(ValueError, match="temperature > 0 requires a PRNG key"):
            fn(tparams, torch.zeros((1, 4), dtype=torch.int32))


class TestMakeGeneratePadded:
    @pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_k=20),
                                    dict(temperature=1.0, prefill_chunk=4)],
                             ids=["greedy", "sampled", "chunked"])
    def test_matches_reference(self, dense, kw):
        jcfg, tcfg, jparams, tparams = dense
        P, steps = 8, 6
        prompt = np.random.RandomState(10).randint(0, jcfg.vocab, (3, P)).astype(np.int32)
        lens = np.array([8, 3, 5], np.int32)
        T = kw.get("temperature", 0.0)
        jfn = jd.make_generate_padded(jcfg, prompt_slots=P, steps=steps, with_health=True, **kw)
        tfn = td.make_generate_padded(tcfg, prompt_slots=P, steps=steps, with_health=True, **kw)
        jargs = (jax.random.PRNGKey(2),) if T else ()
        targs = (prng.key(2),) if T else ()
        want, wok = jfn(jparams, jnp.asarray(prompt), jnp.asarray(lens), *jargs)
        got, ok = tfn(tparams, torch.tensor(prompt), torch.tensor(lens), *targs)
        want = np.asarray(want)
        assert got.shape == want.shape and bool(ok) and bool(wok)
        keys = jax.random.split(jax.random.PRNGKey(2), steps) if T else None
        assert_sequences_match(
            got.numpy()[:, P:], want[:, P:],
            generated_rows(jcfg, jparams, [prompt[i, :lens[i]] for i in range(3)], want[:, P:]),
            lambda i, j: np.asarray(jax.random.gumbel(keys[j], (3, jcfg.vocab)))[i],
            T, kw.get("top_k"))

    def test_out_of_contract_lengths_clear_health(self, dense):
        jcfg, tcfg, jparams, tparams = dense
        prompt = np.ones((2, 8), np.int32)
        for lens in ([0, 4], [9, 4], [8, 1]):
            want = jd.make_generate_padded(jcfg, prompt_slots=8, steps=2, with_health=True)(
                jparams, jnp.asarray(prompt), jnp.asarray(lens, jnp.int32))[1]
            got = td.make_generate_padded(tcfg, prompt_slots=8, steps=2, with_health=True)(
                tparams, torch.tensor(prompt), torch.tensor(lens, dtype=torch.int32))[1]
            assert bool(got) == bool(want)

    def test_rope_rejected_with_reference_text(self):
        jcfg, tcfg = CONFIGS["rope"]
        with pytest.raises(ValueError) as want:
            jd.make_generate_padded(jcfg, prompt_slots=8, steps=2)
        with pytest.raises(ValueError) as got:
            td.make_generate_padded(tcfg, prompt_slots=8, steps=2)
        assert str(got.value) == str(want.value)

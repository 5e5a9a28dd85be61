"""The port's remaining generation factories (tpu_dra_torch/parallel/
decode.py: `make_prefill`, `make_generate_from_cache`, `expand_cache`,
`generate`) against `make_generate` and against the reference's
(tpu_dra/parallel/decode.py) on the reference's weights, dense and MoE,
bf16 and int8.

Within the port, prefill + continuation is `make_generate`'s own
computation, so its tokens are compared exactly.  Against the
reference, greedy tokens are equal up to the first divergence, which
must be a near-tie of the reference's logits (top-2 margin within 2 bf16
ulps of the row's largest logit, test_torch_burnin).  The reference's
logits are recomputed along the generation's own path (`walk_logits`:
the prompt's prefill, then one-token steps): for an MoE model a forward
over the whole sequence routes with another capacity and may drop tokens
the steps keep.  MoE tests assert the smallest router margin above the
tie threshold (`test_torch_moe.router_margins`)."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from test_torch_moe import moe_configs, router_margins
from tpu_dra.parallel import decode as jd
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import prng

torch.set_num_threads(2)

MODELS = {"dense": CONFIGS["dense"], "moe": moe_configs()}
PROMPT_LEN, STEPS = 8, 6


@functools.lru_cache(maxsize=None)
def _walk_fns(jcfg):
    """The reference's prefill over a prompt padded to half the context,
    and its one-token step at a traced position, each compiled once."""
    prefill = jax.jit(lambda params, toks, cache: jd.decode_forward(params, toks, cache, 0, jcfg))
    step = jax.jit(lambda params, tok, cache, p0: jd.decode_forward(params, tok, cache, p0, jcfg))
    return prefill, step


def walk_logits(jcfg, jparams, prompt, generated, kv_int8=False):
    """The reference's logits (len(generated), vocab) that picked each
    generated token of one row: the prompt's prefill, then a one-token
    step per token fed, as its generation runs.  The prompt is padded to
    half the context: trailing pads change no real position, and no
    token's queue place or drop either (a padded prefill's capacity is
    at least the unpadded one's, and equal to it when the prompt exceeds
    it)."""
    prefill, step = _walk_fns(jcfg)
    P = jcfg.seq // 2
    assert len(prompt) <= P
    toks = np.zeros((1, P), np.int32)
    toks[0, :len(prompt)] = prompt
    logits, cache = prefill(jparams, jnp.asarray(toks), jd.init_cache(jcfg, 1, kv_int8))
    rows = [np.asarray(logits[0, len(prompt) - 1], np.float32)]
    for i, tok in enumerate(generated[:-1]):
        logits, cache = step(jparams, jnp.asarray([[tok]], jnp.int32), cache,
                             jnp.int32(len(prompt) + i))
        rows.append(np.asarray(logits[0, -1], np.float32))
    return np.stack(rows)


def assert_greedy_match(jcfg, jparams, prompts, got, want, kv_int8=False):
    """Per row, the port's generated tokens equal the reference's, or
    first differ where the reference is at a near-tie (its own path)."""
    for prompt, g, w in zip(prompts, got, want):
        g, w = list(g), list(w)
        i = next((j for j in range(len(w)) if g[j] != w[j]), None)
        if i is None:
            continue
        row = walk_logits(jcfg, jparams, prompt, w, kv_int8)[i]
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= 2 ** -6 * np.abs(row).max(), (prompt, i, g, w)


def margins(name):
    """`test_torch_moe.router_margins` for the MoE model."""
    return router_margins() if name == "moe" else contextlib.nullcontext()


def _prompts(vocab, batch, seed=11):
    return np.random.RandomState(seed).randint(0, vocab, (batch, PROMPT_LEN)).astype(np.int32)


def _clone(cache):
    return {n: ({k: t.clone() for k, t in leaf.items()} if isinstance(leaf, dict) else leaf.clone())
            for n, leaf in cache.items()}


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(td._kv_tensors(a), td._kv_tensors(b)))


class TestPrefillThenGenerate:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_equals_make_generate_and_reference(self, name, int8):
        jcfg, tcfg = MODELS[name]
        jparams, tparams = both_params(jcfg, quantized=int8)
        prompt = _prompts(jcfg.vocab, 3)
        with margins(name):
            cache, last = td.make_prefill(tcfg, prompt_len=PROMPT_LEN, kv_int8=int8)(
                tparams, torch.tensor(prompt))
            got = td.make_generate_from_cache(tcfg, start_pos=PROMPT_LEN, steps=STEPS)(
                tparams, cache, last).numpy()
            whole = td.make_generate(tcfg, prompt_len=PROMPT_LEN, steps=STEPS, kv_int8=int8)(
                tparams, torch.tensor(prompt)).numpy()
        assert isinstance(cache["k"], dict) == int8
        np.testing.assert_array_equal(got, whole[:, PROMPT_LEN:])
        jcache, jlast = jd.make_prefill(jcfg, prompt_len=PROMPT_LEN, quantized=int8,
                                        kv_int8=int8)(jparams, jnp.asarray(prompt))
        want = np.asarray(jd.make_generate_from_cache(
            jcfg, start_pos=PROMPT_LEN, steps=STEPS, quantized=int8, kv_int8=int8)(
                jparams, jcache, jlast))
        assert_greedy_match(jcfg, jparams, prompt, got, want, int8)

    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_two_continuations_from_one_prefill(self, name):
        """The state is never written: a sampled continuation, then a
        greedy one, then the sampled one again under the same key, each
        from the same prefill, give what `make_generate` gives."""
        _, tcfg = MODELS[name]
        _, tparams = both_params(MODELS[name][0])
        prompt = torch.tensor(_prompts(tcfg.vocab, 2, seed=12))
        cache, last = td.make_prefill(tcfg, prompt_len=PROMPT_LEN)(tparams, prompt)
        before = _clone(cache)
        key = prng.key(7)
        sampled = td.make_generate_from_cache(tcfg, start_pos=PROMPT_LEN, steps=STEPS,
                                              temperature=0.8, top_k=20, with_logprobs=True)
        greedy = td.make_generate_from_cache(tcfg, start_pos=PROMPT_LEN, steps=STEPS,
                                             with_health=True)
        first, lps = sampled(tparams, cache, last, key)
        toks, healthy = greedy(tparams, cache, last)
        again, _ = sampled(tparams, cache, last, key)
        assert _equal(cache, before)
        assert bool(healthy) and torch.equal(first, again)
        want, want_lps = td.make_generate(tcfg, prompt_len=PROMPT_LEN, steps=STEPS,
                                          temperature=0.8, top_k=20, with_logprobs=True)(
            tparams, prompt, key)
        assert torch.equal(first, want[:, PROMPT_LEN:]) and torch.equal(lps, want_lps)
        assert torch.equal(toks, td.make_generate(tcfg, prompt_len=PROMPT_LEN, steps=STEPS)(
            tparams, prompt)[:, PROMPT_LEN:])
        with pytest.raises(ValueError, match="PRNG key"):
            sampled(tparams, cache, last)


class TestExpandCache:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_tiles_like_the_reference(self, int8):
        jcfg, tcfg = MODELS["moe"]
        jparams, tparams = both_params(jcfg)
        prompt = _prompts(jcfg.vocab, 2, seed=13)
        cache, last = td.make_prefill(tcfg, prompt_len=PROMPT_LEN, kv_int8=int8)(
            tparams, torch.tensor(prompt))
        big, big_last = td.expand_cache(cache, last, 3)
        jbig, jbig_last = jd.expand_cache(
            jax.tree_util.tree_map(_to_jax, cache),
            jnp.asarray(last.numpy()), 3)
        for got, want in zip(td._kv_tensors(big), td._kv_tensors(jbig)):
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        np.testing.assert_array_equal(big_last.numpy(), np.asarray(jbig_last))
        assert big["k"] is not cache["k"]

    def test_fanned_out_rows_continue_alike(self):
        """One B=1 prefill tiled to 3 rows: greedy, every row continues as
        the single row does."""
        jcfg, tcfg = MODELS["moe"]
        _, tparams = both_params(jcfg)
        prompt = torch.tensor(_prompts(tcfg.vocab, 1, seed=14))
        cache, last = td.make_prefill(tcfg, prompt_len=PROMPT_LEN)(tparams, prompt)
        gen = td.make_generate_from_cache(tcfg, start_pos=PROMPT_LEN, steps=STEPS)
        one = gen(tparams, cache, last)
        many = gen(tparams, *td.expand_cache(cache, last, 3))
        assert tuple(many.shape) == (3, STEPS)
        assert all(torch.equal(row, one[0]) for row in many)


class TestGenerate:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_matches_reference(self, name, int8):
        jcfg, tcfg = MODELS[name]
        jparams, tparams = both_params(jcfg, quantized=int8)
        prompt = _prompts(jcfg.vocab, 2, seed=15)
        with margins(name):
            got = td.generate(tparams, torch.tensor(prompt), STEPS, tcfg).numpy()
        want = np.asarray(jd.generate(jparams, jnp.asarray(prompt), STEPS, jcfg))
        np.testing.assert_array_equal(got[:, :PROMPT_LEN], prompt)
        assert_greedy_match(jcfg, jparams, prompt, got[:, PROMPT_LEN:], want[:, PROMPT_LEN:])

    def test_sampled_needs_a_key_and_is_keyed(self):
        _, tcfg = MODELS["dense"]
        _, tparams = both_params(MODELS["dense"][0])
        prompt = torch.tensor(_prompts(tcfg.vocab, 2, seed=16))
        with pytest.raises(ValueError, match="PRNG key"):
            td.generate(tparams, prompt, STEPS, tcfg, temperature=0.8)
        a = td.generate(tparams, prompt, STEPS, tcfg, temperature=0.8, key=prng.key(1))
        b = td.generate(tparams, prompt, STEPS, tcfg, temperature=0.8, key=prng.key(1))
        assert torch.equal(a, b)


class TestMoeRefusals:
    """The reference's MoE refusals, message for message: a windowed
    prefill would restart the per-expert capacity queues."""

    def _message(self, fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    def test_prefill_chunk_refused(self):
        jcfg, tcfg = MODELS["moe"]
        for factory in ("make_generate", "make_prefill"):
            want = self._message(lambda: getattr(jd, factory)(jcfg, prompt_len=8, steps=2,
                                                              prefill_chunk=4)
                                 if factory == "make_generate"
                                 else jd.make_prefill(jcfg, prompt_len=8, prefill_chunk=4))
            got = self._message(lambda: getattr(td, factory)(tcfg, prompt_len=8, steps=2,
                                                             prefill_chunk=4)
                                if factory == "make_generate"
                                else td.make_prefill(tcfg, prompt_len=8, prefill_chunk=4))
            assert got == want and "moe_experts" in got
        # A chunk of the whole prompt is one pass: taken.
        td.make_prefill(tcfg, prompt_len=8, prefill_chunk=8)

    def test_suffix_prefill_refused(self):
        jcfg, tcfg = MODELS["moe"]
        want = self._message(lambda: jd._build_prefill_suffix(jcfg, None, 8, 4))
        got = self._message(lambda: td._build_prefill_suffix(tcfg, 8, 4))
        assert got == want and "moe_experts" in got

    def test_serving_config_is_the_config(self):
        _, tcfg = MODELS["moe"]
        assert td.serving_config(tcfg) == tcfg

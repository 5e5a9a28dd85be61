"""The port's speculative decoding (tpu_dra_torch/parallel/speculative.py)
against the reference (tpu_dra/parallel/speculative.py) on the
reference's weights, with the same keys (the port's Threefry is JAX's,
test_torch_prng).

- The pure functions on the same inputs: acceptance flags equal except
  where the uniform lies within 1e-6 of ``p/q`` (the two softmaxes round
  in their own order); drawn tokens equal except where the perturbed
  log-residuals tie within test_torch_prng's gumbel tolerance.
- `draft_params` slices plain and int8 trees as the reference's does.
- Greedy generation equals the port's `make_generate` token for token
  (the contract: any draft), and the reference's tokens and round
  counts.  Sampled generation follows the reference's key schedule, so
  it draws the reference's tokens up to the first divergence, whose round
  must hold a decision the logit tolerance could flip (`NearTies`).
- The speculative-sampling theorem on analytic distributions, as the
  reference pins it (test_speculative.py TestStochasticCore): the output
  is target-distributed for any draft (total variation < 0.02 over
  20000 draws), a perfect draft always accepts, the residual never
  resamples an over-drafted token, and a perfect draft at temperature
  takes ceil(steps / (k + 1)) rounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import both_params
from test_torch_prng import GUMBEL_RTOL
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import speculative as js
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import prng
from tpu_dra_torch.parallel import speculative as ts

torch.set_num_threads(2)

_SHAPE = dict(vocab=128, d_model=32, n_heads=4, d_ff=64, n_layers=4, seq=64, batch=2)
JCFG, TCFG = jb.BurninConfig(**_SHAPE), tb.BurninConfig(**_SHAPE)


@pytest.fixture(scope="module")
def weights():
    return both_params(JCFG)


def _prompt(batch, plen=8, seed=7):
    return np.random.RandomState(seed).randint(0, JCFG.vocab, (batch, plen)).astype(np.int32)


def _logit_pair(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 1.5).astype(np.float32), (rng.randn(*shape) * 1.5).astype(np.float32)


def _assert_draws_match(got, want, perturbed):
    for g, w, z in zip(got.reshape(-1), want.reshape(-1), perturbed.reshape(-1, perturbed.shape[-1])):
        if g != w:
            assert abs(z[g] - z[w]) <= 2 * GUMBEL_RTOL * max(1.0, abs(z[w])), (g, w)


class NearTies:
    """Records, in a port run of `make_generate_speculative` at
    ``temperature``, every decision the logit tolerance (2 bf16 ulps of
    a row's largest logit, test_torch_burnin) could flip: a categorical
    draw whose perturbed top two lie within it, an acceptance test whose
    uniform lies within the ratio's reach of ``p/q``, a residual draw
    whose top two log-residuals lie within theirs.  ``before(j)``: such a
    decision fed the round that committed generated token ``j`` (its
    first token, its draft draws, its acceptance tests and the draws after
    them); the first divergence of two runs lies in the round where their
    decisions first differ."""

    TOL = 2.0 ** -6

    def __init__(self, monkeypatch, temperature):
        self.t = temperature
        self.frontiers = []  # the committed count at each verify pass
        self.events = []  # (verify passes so far, kind)
        self._in_residual = False
        real = {n: getattr(ts, n) for n in ("decode_forward", "acceptance_flags",
                                            "residual_sample")}
        real_cat = prng.categorical

        def decode_forward(params, tokens, cache, p0, cfg):
            if cfg.n_layers == TCFG.n_layers and tokens.shape[1] > 1 and p0 >= 8:
                self.frontiers.append(p0 - 8)
            return real["decode_forward"](params, tokens, cache, p0, cfg)

        def categorical(key, logits):
            if not self._in_residual:
                z = logits + prng.gumbel(key, logits.shape[key.dim() - 1:])
                top2 = torch.topk(z, 2, dim=-1).values
                tol = 2 * self.TOL * logits.abs().amax(-1) + 2 * GUMBEL_RTOL * top2[..., 0].abs()
                self._note("draw", (top2[..., 0] - top2[..., 1] <= tol).any())
            return real_cat(key, logits)

        def acceptance_flags(u, tl, dl, tok, temperature=1.0):
            idx = tok.long()[..., None]
            p = torch.softmax(tl / temperature, -1).gather(-1, idx)[..., 0]
            q = torch.softmax(dl / temperature, -1).gather(-1, idx)[..., 0]
            reach = torch.expm1(4 * self.TOL * torch.maximum(tl.abs().amax(-1), dl.abs().amax(-1))
                                / temperature)
            self._note("accept", ((u - p / q).abs() <= (p / q) * reach + 1e-6).any())
            return real["acceptance_flags"](u, tl, dl, tok, temperature)

        def residual_sample(key, tl, dl, temperature=1.0):
            p, q = torch.softmax(tl / temperature, -1), torch.softmax(dl / temperature, -1)
            eps = torch.expm1(4 * self.TOL * torch.maximum(tl.abs().amax(-1, keepdim=True),
                                                           dl.abs().amax(-1, keepdim=True))
                              / temperature)
            resid = (p - q).clamp(min=0)
            reach = eps * (p + q) / (p - q).abs().clamp(min=1e-30)
            z = torch.log(resid / resid.sum(-1, keepdim=True) + 1e-20) + prng.gumbel(key, tl.shape)
            top = torch.topk(z, 2, dim=-1)
            r = reach.gather(-1, top.indices).sum(-1) + 2 * GUMBEL_RTOL * top.values[..., 0].abs()
            self._note("residual", (top.values[..., 0] - top.values[..., 1] <= r).any())
            self._in_residual = True
            try:
                return real["residual_sample"](key, tl, dl, temperature)
            finally:
                self._in_residual = False

        for name, fn in (("decode_forward", decode_forward), ("acceptance_flags", acceptance_flags),
                         ("residual_sample", residual_sample)):
            monkeypatch.setattr(ts, name, fn)
        monkeypatch.setattr(prng, "categorical", categorical)

    def _note(self, kind, near):
        if bool(near):
            self.events.append((len(self.frontiers), kind))

    def before(self, j: int) -> bool:
        # Round i (the last verify pass whose frontier is at or before j)
        # draws its first token and drafts with i passes counted, and
        # tests and draws after its own pass with i + 1.
        i = max(i for i, f in enumerate(self.frontiers) if f <= j)
        return any(at in (i, i + 1) for at, _ in self.events)


class TestPureFunctions:
    @pytest.mark.parametrize("temperature", [1.0, 0.7])
    def test_acceptance_flags_match(self, temperature):
        tl, dl = _logit_pair(0, (6, 5, 32))
        tok = np.random.RandomState(1).randint(0, 32, (6, 5)).astype(np.int32)
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (6, 5)))
        want = np.asarray(js.acceptance_flags(jnp.asarray(u), jnp.asarray(tl), jnp.asarray(dl),
                                              jnp.asarray(tok), temperature))
        got = ts.acceptance_flags(torch.tensor(u), torch.tensor(tl), torch.tensor(dl),
                                  torch.tensor(tok), temperature).numpy()
        p = torch.softmax(torch.tensor(tl) / temperature, -1).numpy()
        q = torch.softmax(torch.tensor(dl) / temperature, -1).numpy()
        ratio = (np.take_along_axis(p, tok[..., None], -1)
                 / np.take_along_axis(q, tok[..., None], -1))[..., 0]
        sure = np.abs(u - ratio) > 1e-6
        np.testing.assert_array_equal(got[sure], want[sure])

    @pytest.mark.parametrize("temperature", [1.0, 0.7])
    def test_residual_sample_matches(self, temperature):
        tl, dl = _logit_pair(2, (8, 64))
        key = jax.random.PRNGKey(9)
        want = np.asarray(js.residual_sample(key, jnp.asarray(tl), jnp.asarray(dl), temperature))
        got = ts.residual_sample(prng.key(9), torch.tensor(tl), torch.tensor(dl), temperature)
        assert got.dtype == torch.int32
        p = np.asarray(jax.nn.softmax(jnp.asarray(tl) / temperature, -1))
        q = np.asarray(jax.nn.softmax(jnp.asarray(dl) / temperature, -1))
        resid = np.maximum(p - q, 0)
        resid /= resid.sum(-1, keepdims=True)
        z = np.log(resid + 1e-20) + np.asarray(jax.random.gumbel(key, tl.shape))
        _assert_draws_match(got.numpy(), want, z)

    def test_residual_of_equal_distributions_falls_back_to_p(self):
        """p == q leaves no residual mass: the draw is from p itself."""
        tl, _ = _logit_pair(3, (4, 16))
        got = ts.residual_sample(prng.key(1), torch.tensor(tl), torch.tensor(tl))
        want = np.asarray(js.residual_sample(jax.random.PRNGKey(1), jnp.asarray(tl),
                                             jnp.asarray(tl)))
        z = np.log(np.asarray(jax.nn.softmax(jnp.asarray(tl), -1)) + 1e-20) + np.asarray(
            jax.random.gumbel(jax.random.PRNGKey(1), tl.shape))
        _assert_draws_match(got.numpy(), want, z)

    def test_accept_or_resample_matches(self):
        tl, dl = _logit_pair(4, (64, 16))
        draft = np.random.RandomState(5).randint(0, 16, 64).astype(np.int32)
        wt, wa = js.accept_or_resample(jax.random.PRNGKey(6), jnp.asarray(tl), jnp.asarray(dl),
                                       jnp.asarray(draft), 0.9)
        gt, ga = ts.accept_or_resample(prng.key(6), torch.tensor(tl), torch.tensor(dl),
                                       torch.tensor(draft), 0.9)
        assert gt.dtype == torch.int32
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


class TestDraftParams:
    @pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
    def test_slices_layers_like_the_reference(self, quantized):
        jparams, tparams = both_params(JCFG, quantized=quantized)
        want = js.draft_params(jparams, 2)
        got = ts.draft_params(tparams, 2)
        assert got["embed"] is tparams["embed"] and got["ln_f"] is tparams["ln_f"]
        flat_want = jax.tree_util.tree_leaves_with_path(want["layers"])
        flat_got = jax.tree_util.tree_leaves_with_path(got["layers"])
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            assert tuple(g.shape) == w.shape and g.shape[0] == 2
            # The port keeps plain layer matrices in bf16 (params_from_numpy).
            w = w.astype(jnp.bfloat16) if g.dtype == torch.bfloat16 else w
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


class TestGeneration:
    @pytest.mark.parametrize("draft_layers", [1, 4])
    @pytest.mark.parametrize("batch", [1, 3])
    def test_greedy_equals_make_generate_and_reference(self, weights, draft_layers, batch):
        jparams, tparams = weights
        prompt = _prompt(batch)
        kw = dict(prompt_len=8, steps=16, draft_layers=draft_layers, draft_len=4, with_stats=True)
        want, wrounds, wok = js.make_generate_speculative(JCFG, **kw)(jparams, jnp.asarray(prompt))
        got, rounds, ok = ts.make_generate_speculative(TCFG, **kw)(tparams, torch.tensor(prompt))
        plain = td.make_generate(TCFG, prompt_len=8, steps=16)(tparams, torch.tensor(prompt))
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(wrounds) and bool(ok) and bool(wok)
        if draft_layers == 4:
            assert rounds == 4  # a perfect draft commits k + 1 = 5 a round

    @pytest.mark.parametrize("draft_layers", [2, 4])
    def test_sampled_matches_reference(self, weights, draft_layers, monkeypatch):
        """Tokens equal the reference's up to the first divergence, and
        the round of a divergence holds a decision of the port's run that
        the logit tolerance could flip (`NearTies`); from there on the two
        runs may commit other counts a round and draw under other keys."""
        jparams, tparams = weights
        prompt = _prompt(2, seed=3)
        kw = dict(prompt_len=8, steps=12, draft_layers=draft_layers, draft_len=3,
                  temperature=0.8, with_stats=True)
        want, wrounds, _ = js.make_generate_speculative(JCFG, **kw)(
            jparams, jnp.asarray(prompt), jax.random.PRNGKey(11))
        near = NearTies(monkeypatch, 0.8)
        got, rounds, ok = ts.make_generate_speculative(TCFG, **kw)(
            tparams, torch.tensor(prompt), prng.key(11))
        assert bool(ok) and got.shape == (2, 20)
        got, want = got.numpy()[:, 8:], np.asarray(want)[:, 8:]
        first = min((int(np.flatnonzero(g != w)[0]) for g, w in zip(got, want)
                     if (g != w).any()), default=None)
        if first is None:
            assert rounds == int(wrounds)
        else:
            assert near.before(first), (first, near.frontiers, near.events)

    def test_int8_greedy_equals_int8_make_generate(self):
        _, tparams = both_params(JCFG, quantized=True)
        prompt = torch.tensor(_prompt(2))
        for kv_int8 in (False, True):
            want = td.make_generate(TCFG, prompt_len=8, steps=10, kv_int8=kv_int8)(tparams, prompt)
            got = ts.make_generate_speculative(TCFG, prompt_len=8, steps=10, draft_layers=2,
                                               draft_len=3, kv_int8=kv_int8)(tparams, prompt)
            assert torch.equal(got, want)

    def test_same_key_repeats_other_key_differs(self, weights):
        _, tparams = weights
        fn = ts.make_generate_speculative(TCFG, prompt_len=8, steps=10, draft_layers=2,
                                          draft_len=3, temperature=0.9)
        prompt = torch.tensor(_prompt(2))
        a, b, a2 = (fn(tparams, prompt, prng.key(s)) for s in (1, 2, 1))
        assert torch.equal(a, a2) and not torch.equal(a, b)


class TestValidation:
    @pytest.mark.parametrize("kw", [
        dict(draft_layers=0, draft_len=2), dict(draft_layers=5, draft_len=2),
        dict(draft_layers=2, draft_len=0), dict(draft_layers=2, draft_len=8, steps=50),
    ])
    def test_errors_match_reference(self, kw):
        kw = {"prompt_len": 8, "steps": 8, **kw}
        with pytest.raises(ValueError) as want:
            js.make_generate_speculative(JCFG, **kw)
        with pytest.raises(ValueError) as got:
            ts.make_generate_speculative(TCFG, **kw)
        assert str(got.value) == str(want.value)

    def test_missing_key_rejected(self, weights):
        _, tparams = weights
        fn = ts.make_generate_speculative(TCFG, prompt_len=8, steps=4, draft_layers=2,
                                          draft_len=2, temperature=0.5)
        with pytest.raises(ValueError, match="temperature > 0 requires a PRNG key"):
            fn(tparams, torch.tensor(_prompt(2)))

    def test_moe_configs_cannot_be_built(self):
        """An MoE config is built now (the family is ported), and the
        factory refuses it as the reference's does, message for message."""
        cfg = tb.BurninConfig(**{**_SHAPE, "moe_experts": 4})
        with pytest.raises(ValueError, match="dense configs only") as got:
            ts.make_generate_speculative(cfg, prompt_len=8, steps=4, draft_layers=2, draft_len=2)
        with pytest.raises(ValueError) as want:
            js.make_generate_speculative(jb.BurninConfig(**{**_SHAPE, "moe_experts": 4}),
                                         prompt_len=8, steps=4, draft_layers=2, draft_len=2)
        assert str(got.value) == str(want.value)


class TestStochasticCore:
    def test_output_matches_target_distribution(self):
        V, N = 4, 20000
        tl = torch.tensor([1.0, 0.2, -0.5, 0.7])
        ql = torch.tensor([-0.3, 0.9, 0.1, 0.0])
        kq, kar = prng.split(prng.key(0))
        draft = prng.categorical(kq, ql.repeat(N, 1)).to(torch.int32)
        toks, acc = ts.accept_or_resample(kar, tl.repeat(N, 1), ql.repeat(N, 1), draft)
        emp = np.bincount(toks.numpy(), minlength=V) / N
        want = torch.softmax(tl, -1).numpy()
        assert 0.5 * np.abs(emp - want).sum() < 0.02  # total variation
        assert 0.05 < float(acc.float().mean()) < 0.95

    def test_identical_distributions_always_accept(self):
        tl = torch.tensor([0.3, -1.0, 0.8])
        N = 4000
        kq, kar = prng.split(prng.key(1))
        draft = prng.categorical(kq, tl.repeat(N, 1)).to(torch.int32)
        toks, acc = ts.accept_or_resample(kar, tl.repeat(N, 1), tl.repeat(N, 1), draft)
        assert bool(acc.all())
        assert torch.equal(toks, draft)

    def test_residual_excludes_overrepresented_tokens(self):
        tl = torch.log(torch.tensor([0.1, 0.6, 0.3]))
        ql = torch.log(torch.tensor([0.6, 0.2, 0.2]))  # token 0 over-drafted
        toks = ts.residual_sample(prng.key(2), tl.repeat(2000, 1), ql.repeat(2000, 1))
        assert not bool((toks == 0).any())

    def test_perfect_draft_full_acceptance_at_temperature(self, weights):
        _, tparams = weights
        fn = ts.make_generate_speculative(TCFG, prompt_len=8, steps=16, draft_layers=4,
                                          draft_len=7, temperature=0.8, with_stats=True)
        _, rounds, ok = fn(tparams, torch.tensor(_prompt(2)), prng.key(5))
        assert bool(ok) and rounds == 2

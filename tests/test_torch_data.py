"""The port's input pipeline (tpu_dra_torch/parallel/data.py, with
`prng.randint`/`bernoulli` and `burnin.sample_tokens(key=)`) against the
reference's (tpu_dra/parallel/data.py, `jax.random`, burnin.sample_tokens).

Tolerances: draws and batches bitwise; `train_on_stream` from the
reference's own initial state within `tests/test_torch_train.py`'s loss
tolerance, ``1e-2`` relative (bf16 products summed in another order; the
reference's step here is its own jitted one, excess precision and all)."""

import jax
import numpy as np
import pytest
import torch

from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import data as jd
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import data as td
from tpu_dra_torch.parallel import prng
from tpu_dra_torch.parallel.weights import state_from_numpy

torch.set_num_threads(2)

_SHAPE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=64, batch=8)
# (minval, maxval): span 1, powers of two, non-powers of two, the burn-in's
# vocabularies, spans near 2**31 and 2**32, negative bounds, an empty span.
SPANS = [(0, 1), (0, 2), (0, 7), (0, 64), (0, 1000), (0, 32768), (3, 3 ** 19),
         (0, 2 ** 31 - 1), (-5, 2 ** 31 - 1), (-(2 ** 31), 2 ** 31 - 1), (-100, -3), (9, 9),
         (10, 2)]
SEEDS = [0, 42, -1, 2 ** 31 - 1]


def configs(**overrides):
    fields = {**_SHAPE, **overrides}
    return jb.BurninConfig(**fields), tb.BurninConfig(**fields)


class TestDraws:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("span", SPANS, ids=lambda s: f"{s[0]}_{s[1]}")
    def test_randint_bitwise(self, span, seed):
        lo, hi = span
        for shape in [(5, 1), (3, 129)]:
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
            got = prng.randint(prng.key(seed), shape, lo, hi)
            assert got.dtype == torch.int32 and want.dtype == np.int32
            np.testing.assert_array_equal(got.numpy(), want)

    def test_randint_refuses_bounds_outside_int32(self):
        with pytest.raises(OverflowError):
            prng.randint(prng.key(0), (2,), 0, 2 ** 31)

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 1 / 3, 1.0])
    def test_bernoulli_bitwise(self, p, seed):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (7, 33)))
        got = prng.bernoulli(prng.key(seed), p, (7, 33))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed", [0, 42, 7])
    @pytest.mark.parametrize("shape", [{}, dict(vocab=1000, batch=3, seq=50), _SHAPE],
                             ids=["default", "vocab1000", "small"])
    def test_sample_tokens_key_form_is_the_references_batch(self, shape, seed):
        jcfg, tcfg = jb.BurninConfig(**shape), tb.BurninConfig(**shape)
        want = np.asarray(jb.sample_tokens(jcfg, jax.random.PRNGKey(seed)))
        got = tb.sample_tokens(tcfg, device="cpu", key=prng.key(seed))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_generator_form_unchanged(self):
        _, tcfg = configs()
        a = tb.sample_tokens(tcfg, device="cpu")
        b = tb.sample_tokens(tcfg, torch.Generator().manual_seed(42), device="cpu")
        assert torch.equal(a, b)


class TestStream:
    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("vocab", [64, 1000])
    def test_first_batches_bitwise(self, vocab, seed):
        jcfg, tcfg = configs(vocab=vocab)
        want = jd.synthetic_stream(jcfg, seed=seed)
        got = td.synthetic_stream(tcfg, seed=seed)
        for _ in range(4):
            g = next(got)
            assert g.device.type == "cpu" and g.dtype == torch.int32
            assert tuple(g.shape) == (tcfg.batch, tcfg.seq)
            np.testing.assert_array_equal(g.numpy(), np.asarray(next(want)))

    def test_distinct_across_steps_and_seeds(self):
        _, tcfg = configs()
        s = td.synthetic_stream(tcfg, seed=3)
        first, second = next(s), next(s)
        assert not torch.equal(first, second)
        assert not torch.equal(first, next(td.synthetic_stream(tcfg, seed=4)))


class TestPrefetch:
    @pytest.mark.parametrize("size", [1, 2, 3, 10])
    def test_order_and_contents_any_depth(self, size):
        _, tcfg = configs()
        want = [b for _, b in zip(range(7), td.synthetic_stream(tcfg, seed=5))]
        got = [b for _, b in zip(range(7), td.prefetch_to_device(
            td.synthetic_stream(tcfg, seed=5), size=size, device="cpu"))]
        assert len(got) == 7
        for a, b in zip(want, got):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("size", [1, 3, 8])
    @pytest.mark.parametrize("n", [0, 1, 3])
    def test_short_iterators_drain_fully_in_order(self, n, size):
        batches = [torch.full((2, 3), i, dtype=torch.int32) for i in range(n)]
        out = list(td.prefetch_to_device(iter(batches), size=size, device="cpu"))
        assert [int(b[0, 0]) for b in out] == list(range(n))
        # The reference drains the same iterator to the same count.
        assert len(list(jd.prefetch_to_device(iter([np.asarray(b) for b in batches]),
                                              size=size))) == n

    def test_takes_numpy_batches(self):
        out = list(td.prefetch_to_device(iter([np.arange(6, dtype=np.int32)]), device="cpu"))
        assert torch.equal(out[0], torch.arange(6, dtype=torch.int32))

    @pytest.mark.parametrize("size", [0, -1])
    def test_bad_size_raises_the_references_error(self, size):
        with pytest.raises(ValueError) as want:
            jd.prefetch_to_device(iter([]), size=size)
        with pytest.raises(ValueError) as got:
            td.prefetch_to_device(iter([]), size=size, device="cpu")
        assert str(got.value) == str(want.value)

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.prefetch_to_device(iter([]))


class TestTrainOnStream:
    @pytest.mark.parametrize("steps", [2, 5])
    def test_matches_reference_from_its_state(self, steps, monkeypatch):
        jcfg, tcfg = configs()
        _, jstate = jb.make_train_step(jcfg)
        tstate = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        real = td.make_train_step

        def from_reference_state(config, device):
            step, _ = real(config, device, with_state=False)
            return step, tstate

        monkeypatch.setattr(td, "make_train_step", from_reference_state)
        want = jd.train_on_stream(jcfg, steps=steps, seed=1)
        got = td.train_on_stream(tcfg, steps=steps, seed=1, device="cpu")
        assert want.ok and got.ok, (want, got)
        assert got.steps == want.steps == max(2, steps)
        np.testing.assert_allclose([got.loss_first, got.loss_last],
                                   [want.loss_first, want.loss_last], rtol=1e-2)

    def test_learns_across_distinct_batches(self):
        _, tcfg = configs()
        r = td.train_on_stream(tcfg, steps=10, seed=1, device="cpu")
        assert r.ok, r.error
        assert r.loss_last < r.loss_first and r.step_seconds_p50 > 0

    def test_reports_never_raises(self):
        jbad, tbad = configs(optimizer="nope")
        want = jd.train_on_stream(jbad, steps=2)
        got = td.train_on_stream(tbad, steps=2, device="cpu")
        assert not want.ok and not got.ok
        assert got.error == want.error and "optimizer" in got.error

    def test_no_card_is_a_report(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        _, tcfg = configs()
        r = td.train_on_stream(tcfg, steps=2)
        assert not r.ok and "no CUDA device" in r.error

"""The port's Threefry PRNG (tpu_dra_torch/parallel/prng.py) against
`jax.random` with its defaults (threefry2x32, partitionable): keys,
`fold_in`, `split`, `bits` and `uniform` bitwise equal; `gumbel` within
``2**-20 * max(1, |g|)`` (``log`` rounds in its own order on each side:
measured 1.2e-7 relative); `categorical` equal in both counter layouts
(one key over a whole batch, one key a row) except where the perturbed
logits ``logits + g`` tie within that gumbel tolerance."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_dra_torch.parallel import prng

torch.set_num_threads(2)

COMMON = settings(deadline=None, max_examples=25)
INT32 = st.integers(min_value=-(2 ** 31), max_value=2 ** 31 - 1)
UINT31 = st.integers(min_value=0, max_value=2 ** 31 - 1)
# (V,), (B, V) and odd sizes, including the serving vocabulary's width.
SHAPES = [(1,), (7,), (64,), (3, 5), (2, 33), (4, 64), (2, 32768)]
GUMBEL_RTOL = 2.0 ** -20


def jkey(seed: int):
    return jax.random.PRNGKey(seed)


def data(k) -> np.ndarray:
    """A JAX key's two words as int64."""
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k).astype(np.int64)


class TestKeys:
    @COMMON
    @given(seed=INT32)
    def test_key_matches_prngkey(self, seed):
        np.testing.assert_array_equal(prng.key(seed).numpy(), data(jkey(seed)))

    def test_key_of_minus_one(self):
        assert prng.key(-1).tolist() == [0, 4294967295]

    @COMMON
    @given(seed=INT32, d=UINT31)
    def test_fold_in_matches(self, seed, d):
        want = data(jax.random.fold_in(jkey(seed), d))
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), d).numpy(), want)

    @COMMON
    @given(seed=INT32, n=st.integers(min_value=1, max_value=9))
    def test_split_matches(self, seed, n):
        want = data(jax.random.split(jkey(seed), n))
        np.testing.assert_array_equal(prng.split(prng.key(seed), n).numpy(), want)

    def test_split_default_and_nested(self):
        k = jkey(11)
        np.testing.assert_array_equal(prng.split(prng.key(11)).numpy(), data(jax.random.split(k)))
        np.testing.assert_array_equal(prng.split(prng.key(11), (2, 3)).numpy(),
                                      data(jax.random.split(k, (2, 3))))

    def test_batched_fold_in_is_the_vmapped_one(self):
        """(B,) seeds and (B,) positions in one pass: the engine's per-row
        keys, equal to the reference's vmapped ``fold_in(PRNGKey(s), p)``."""
        seeds = np.array([0, -1, 7, 2 ** 31 - 1, -(2 ** 31)], np.int32)
        pos = np.array([0, 1, 511, 1023, 2 ** 31 - 1], np.int32)
        want = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(seeds, pos)
        got = prng.fold_in(prng.key(torch.tensor(seeds)), torch.tensor(pos))
        np.testing.assert_array_equal(got.numpy(), data(want))

    def test_reference_key_data_is_accepted(self):
        """A key handed over as the reference's uint32 words."""
        k = np.asarray(jkey(5))
        np.testing.assert_array_equal(prng.split(k, 3).numpy(), data(jax.random.split(jkey(5), 3)))

    def test_bad_key_shape_rejected(self):
        with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
            prng.split(torch.zeros(3, dtype=torch.int64))


class TestDraws:
    @COMMON
    @given(seed=INT32, shape=st.sampled_from(SHAPES))
    def test_bits_match(self, seed, shape):
        want = np.asarray(jax.random.bits(jkey(seed), shape)).astype(np.int64)
        np.testing.assert_array_equal(prng.bits(prng.key(seed), shape).numpy(), want)

    @COMMON
    @given(seed=INT32, shape=st.sampled_from(SHAPES),
           bounds=st.sampled_from([(0.0, 1.0), (np.finfo(np.float32).tiny, 1.0)]))
    def test_uniform_bitwise(self, seed, shape, bounds):
        """The bounds decoding draws under (a span of 1: the scale is
        exact, one rounding in the shift)."""
        lo, hi = bounds
        want = np.asarray(jax.random.uniform(jkey(seed), shape, minval=lo, maxval=hi))
        got = prng.uniform(prng.key(seed), shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    @COMMON
    @given(seed=INT32, shape=st.sampled_from(SHAPES))
    def test_uniform_other_bounds_within_one_ulp(self, seed, shape):
        """Other bounds: within one float32 ulp of the span (XLA fuses the
        scale and the shift into one multiply-add; the port rounds the
        product first, by at most half an ulp of it, and the shift can
        cancel most of the value)."""
        want = np.asarray(jax.random.uniform(jkey(seed), shape, minval=-2.0, maxval=3.5))
        got = prng.uniform(prng.key(seed), shape, minval=-2.0, maxval=3.5).numpy()
        assert np.all(np.abs(got - want) <= np.spacing(np.float32(5.5)))

    @COMMON
    @given(seed=INT32, shape=st.sampled_from(SHAPES))
    def test_gumbel_close(self, seed, shape):
        want = np.asarray(jax.random.gumbel(jkey(seed), shape))
        got = prng.gumbel(prng.key(seed), shape).numpy()
        assert np.all(np.abs(got - want) <= GUMBEL_RTOL * np.maximum(1.0, np.abs(want)))

    def test_gumbel_first_multithreaded_call_over_the_vocabulary(self, tmp_path):
        """A (2, 32768) draw as a fresh process's first call with 8
        threads: torch's CPU float32 ``log`` can return one thread's chunk
        off on that call, so the CPU path takes its logs in float64.  The
        fault is intermittent: this may pass without the float64 path."""
        out = tmp_path / "g.npy"
        code = ("import sys, numpy as np, torch; torch.set_num_threads(8); "
                "from tpu_dra_torch.parallel import prng; "
                "np.save(sys.argv[1], prng.gumbel(prng.key(7), (2, 32768)).numpy())")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        subprocess.run([sys.executable, "-c", code, str(out)], check=True, env=env, timeout=120)
        got = np.load(out)
        want = np.asarray(jax.random.gumbel(jkey(7), (2, 32768)))
        assert np.all(np.abs(got - want) <= GUMBEL_RTOL * np.maximum(1.0, np.abs(want)))

    def test_batched_keys_count_per_row(self):
        """(B, 2) keys and a (V,) draw: row b is the draw of key b alone."""
        keys = prng.split(prng.key(3), 4)
        got = prng.bits(keys, (33,))
        for b in range(4):
            want = np.asarray(jax.random.bits(jax.random.split(jkey(3), 4)[b], (33,)))
            np.testing.assert_array_equal(got[b].numpy(), want.astype(np.int64))

    def test_float32_only(self):
        for fn in (lambda: prng.uniform(prng.key(0), (3,), dtype=torch.float64),
                   lambda: prng.categorical(prng.key(0), torch.zeros(4, dtype=torch.bfloat16))):
            with pytest.raises(ValueError, match="float32"):
                fn()


def assert_categorical_matches(got, want, perturbed):
    """Equal picks, except where the perturbed row's top two lie within
    the gumbel tolerance of each other."""
    for g, w, z in zip(got.reshape(-1), want.reshape(-1), perturbed.reshape(-1, perturbed.shape[-1])):
        if g != w:
            assert abs(z[g] - z[w]) <= 2 * GUMBEL_RTOL * max(1.0, abs(z[w])), (g, w)


class TestCategorical:
    @COMMON
    @given(seed=INT32, rows=st.integers(min_value=1, max_value=4),
           vocab=st.sampled_from([2, 64, 1000]))
    def test_one_key_over_the_batch(self, seed, rows, vocab):
        """`make_generate`'s layout: one key, counters flat over (B, V)."""
        logits = np.random.RandomState(seed % 1000).randn(rows, vocab).astype(np.float32) * 2
        want = np.asarray(jax.random.categorical(jkey(seed), jnp.asarray(logits)))
        got = prng.categorical(prng.key(seed), torch.tensor(logits))
        assert got.dtype == torch.int64
        z = logits + np.asarray(jax.random.gumbel(jkey(seed), logits.shape))
        assert_categorical_matches(got.numpy(), want, z)

    @COMMON
    @given(seed=INT32, pos=UINT31, vocab=st.sampled_from([2, 64, 1000]))
    def test_one_key_a_row(self, seed, pos, vocab):
        """The engine's layout: row b under fold_in(key(seed_b), pos_b),
        counters over V alone (the reference vmaps its pick)."""
        seeds = np.array([seed, seed ^ 1, 3], np.int32)
        positions = np.array([pos, pos, 17], np.int32)
        logits = np.random.RandomState(pos % 1000).randn(3, vocab).astype(np.float32) * 2
        jkeys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s), p))(seeds, positions)
        want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(logits)))
        keys = prng.fold_in(prng.key(torch.tensor(seeds)), torch.tensor(positions))
        got = prng.categorical(keys, torch.tensor(logits))
        z = logits + np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (vocab,)))(jkeys))
        assert_categorical_matches(got.numpy(), want, z)

    def test_filtered_logits_never_drawn(self):
        """A -inf logit (a filtered token) is never drawn."""
        logits = torch.full((2, 8), -torch.inf)
        logits[:, 3] = 0.0
        assert prng.categorical(prng.key(1), logits).tolist() == [3, 3]

    def test_key_batch_must_match_logits(self):
        with pytest.raises(ValueError, match="do not match"):
            prng.categorical(prng.split(prng.key(0), 3), torch.zeros(2, 8))

"""The port's int8 quantization (tpu_dra_torch/parallel/quant.py) against
the reference (tpu_dra/parallel/quant.py), and the quantized tree's way
into the port (weights.params_from_numpy, weights.cast_matrices).

Tolerance: none.  Quantizing is f32 arithmetic with one rounding (half to
even on both sides), so values and scales must be equal exactly; so must
the dequantized values and the byte counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import quant as jq
from tpu_dra_torch.parallel import quant as tq
from tpu_dra_torch.parallel.weights import cast_matrices

torch.set_num_threads(2)


def _torch_tree(tree):
    """A numpy tree as torch tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_trees_equal(got, want):
    """``got`` (torch) equal to ``want`` (numpy): keys, dtypes, values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# (shape, contraction axes): the weights' own layouts and the KV rows'.
TENSORS = {
    "embed": ((64, 32), (1,)),
    "wqkv": ((2, 32, 3, 4, 8), (1,)),
    "wo": ((2, 4, 8, 32), (1, 2)),
    "kv_rows": ((3, 5, 4, 8), (3,)),
}


class TestQuantizeTensor:
    @pytest.mark.parametrize("name", sorted(TENSORS))
    def test_values_and_scales_equal_the_reference(self, name):
        """Including a zero channel (scale 1/127, values 0), a channel
        whose scale is exactly 1 so that its halves round to even, and
        bf16-exact input."""
        shape, axes = TENSORS[name]
        rng = np.random.RandomState(0)
        w = (rng.randn(*shape) * 3).astype(np.float32)
        zero = tuple(slice(None) if a in axes else 0 for a in range(len(shape)))
        ties = tuple(slice(None) if a in axes else -1 for a in range(len(shape)))
        w[zero] = 0.0
        chan = np.zeros(w[ties].size, np.float32)
        chan[:5] = [127.0, 0.5, -0.5, 1.5, 2.5]
        w[ties] = chan.reshape(w[ties].shape)
        for src in (w, np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)):
            want = jq.quantize_tensor(jnp.asarray(src), axes)
            got = tq.quantize_tensor(torch.tensor(src), axes)
            _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
            assert not got["q"][zero].any()
            assert torch.all(got["s"][zero] == np.float32(1.0) / np.float32(127.0))
            assert got["q"][ties].reshape(-1)[:5].tolist() == [127, 0, 0, 2, 2]

    def test_bf16_input_quantizes_its_f32_widening(self):
        x = torch.randn(3, 2, 4, 8).to(torch.bfloat16)
        got = tq.quantize_tensor(x, (3,))
        want = tq.quantize_tensor(x.float(), (3,))
        assert torch.equal(got["q"], want["q"]) and torch.equal(got["s"], want["s"])


class TestHelpers:
    def test_dequantize_matches_and_passes_plain_tensors(self):
        shape, axes = TENSORS["wo"]
        w = np.random.RandomState(1).randn(*shape).astype(np.float32)
        jleaf = jq.quantize_tensor(jnp.asarray(w), axes)
        tleaf = tq.quantize_tensor(torch.tensor(w), axes)
        want = np.asarray(jq.dequantize(jleaf))
        np.testing.assert_array_equal(tq.dequantize(tleaf).numpy(), want)
        want16 = np.asarray(jq.dequantize(jleaf).astype(jnp.bfloat16), np.float32)
        got16 = tq.dequantize_bf16(tleaf)
        assert got16.dtype == torch.bfloat16
        np.testing.assert_array_equal(got16.float().numpy(), want16)
        plain = torch.randn(3)
        assert tq.dequantize(plain) is plain and tq.dequantize_bf16(plain) is plain

    def test_leaf_and_tree_predicates_match(self):
        jparams, _ = both_params(CONFIGS["dense"][0])
        jqp = jq.quantize_params(jparams)
        tqp = tq.quantize_params(_torch_tree(jax.tree_util.tree_map(np.asarray, jparams)))
        for leaf in ({"q": 1, "s": 2}, {"q": 1}, {"q": 1, "s": 2, "x": 3}, torch.zeros(2)):
            assert tq.is_quantized_leaf(leaf) == jq.is_quantized_leaf(leaf)
        assert tq.is_quantized(tqp) and jq.is_quantized(jqp)
        assert not tq.is_quantized({"embed": torch.zeros(2)})

    @pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
    def test_tree_bytes_match(self, quantized):
        jcfg, _ = CONFIGS["dense"]
        jparams, _ = both_params(jcfg, quantized=quantized)
        tparams = _torch_tree(jax.tree_util.tree_map(np.asarray, jparams))
        assert tq.tree_bytes(tparams) == jq.tree_bytes(jparams)

    def test_cache_bytes_follow_the_int8_storage(self):
        """An int8 pool holds 1 + 4/d_head bytes an element against bf16's 2."""
        from tpu_dra.parallel import paged as jp
        from tpu_dra_torch.parallel import paged as tp

        jcfg, tcfg = CONFIGS["dense"]
        for kv_int8 in (False, True):
            want = jq.tree_bytes(jp.init_block_pool(jcfg, 5, 4, kv_int8))
            assert tq.tree_bytes(tp.init_block_pool(tcfg, 5, 4, kv_int8, device="cpu")) == want


class TestQuantizeParams:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_tree_equals_the_reference(self, name):
        jcfg, _ = CONFIGS[name]
        jparams = jb.init_params(jcfg, jax.random.PRNGKey(3))
        want = jax.tree_util.tree_map(np.asarray, jq.quantize_params(jparams))
        got = tq.quantize_params(_torch_tree(jax.tree_util.tree_map(np.asarray, jparams)))
        _assert_trees_equal(got, want)

    def test_params_from_numpy_keeps_the_int8_tree(self):
        """The reference's quantized tree crosses as int8 values and f32
        scales; cast_matrices leaves the pairs alone."""
        jparams, tparams = both_params(CONFIGS["dense"][0], quantized=True)
        want = jax.tree_util.tree_map(np.asarray, jparams)
        _assert_trees_equal(tparams, want)
        again = cast_matrices(tparams)
        for name in ("wqkv", "wo", "w1", "w2"):
            assert again["layers"][name] is tparams["layers"][name]
        assert again["embed"] is tparams["embed"]

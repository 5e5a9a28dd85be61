"""The port's burn-in LM (tpu_dra_torch/parallel/burnin.py, weights.py)
against the reference (tpu_dra/parallel/burnin.py) on the reference's own
weights: config, parameter tree, RoPE tables and the dense forward.

Tolerance, shared by the parity tests of the port: logits within 2 bf16
ulps of the reference row's magnitude (``rtol = 2**-6``, ``atol = 2**-6 *
max|ref|``).  The port rounds to bf16 at the reference's source-level
points; XLA on the CPU may keep excess precision inside a fusion, and
both sum in their own order, so the two are not bitwise equal.  Argmax
must be identical wherever the reference's top-2 margin exceeds that
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import quant as jquant
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel.weights import MATRICES, params_from_numpy

torch.set_num_threads(2)

_SHAPE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4)
# test_serve.CFG's shape, and its RoPE variant: (reference, port) pairs.
CONFIGS = {
    "dense": (jb.BurninConfig(**_SHAPE), tb.BurninConfig(**_SHAPE)),
    "rope": (jb.BurninConfig(**_SHAPE, rope=True), tb.BurninConfig(**_SHAPE, rope=True)),
}


def both_params(cfg, seed: int = 0, quantized: bool = False):
    """The reference's params (int8, through its ``quantize_params``,
    when ``quantized``) and the port's copy of them on the CPU."""
    jparams = jb.init_params(cfg, jax.random.PRNGKey(seed))
    if quantized:
        jparams = jquant.quantize_params(jparams)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def assert_logits_close(got, want):
    """``got``/``want`` (..., vocab) f32 numpy: the tolerance above, and
    identical argmax wherever the reference is not at a near-tie."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 2.0 ** -6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


class TestConfig:
    def test_fields_and_defaults_match_the_reference(self):
        import dataclasses

        ref = {f.name: f.default for f in dataclasses.fields(jb.BurninConfig)}
        port = {f.name: f.default for f in dataclasses.fields(tb.BurninConfig)}
        assert port == ref

    @pytest.mark.parametrize(
        "field,value",
        [("ring_attention", True), ("ulysses_attention", True),
         ("flash_attention", True), ("moe_experts", 4), ("pipeline_stages", 2)],
    )
    def test_unserved_fields_rejected(self, field, value):
        if field == "flash_attention":
            # Ported: the config takes it, and the model rejects it only
            # where its tiles cannot cut the sequence (the reference's rule).
            cfg = tb.BurninConfig(**{**_SHAPE, field: value, "seq": 12})
            params = tb.init_params(cfg, device="cpu")
            with pytest.raises(ValueError, match=f"{field} needs seq % 8 == 0"):
                tb.forward(params, torch.zeros((1, 12), dtype=torch.int32), cfg)
            return
        with pytest.raises(ValueError, match=field):
            tb.BurninConfig(**{field: value})

    def test_d_head_check(self):
        assert tb.BurninConfig(d_model=32, n_heads=4).d_head == 8
        with pytest.raises(ValueError, match="not divisible"):
            tb.BurninConfig(d_model=30, n_heads=4).d_head


class TestParams:
    def test_init_params_tree_shapes_match_the_reference(self):
        jcfg, tcfg = CONFIGS["dense"]
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jb.init_params(jcfg))
        got = tb.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
        assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(got))

    def test_init_params_is_seeded_and_fan_in_scaled(self):
        _, tcfg = CONFIGS["dense"]
        a = tb.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
        b = tb.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
        assert torch.equal(a["layers"]["w2"], b["layers"]["w2"])
        # N(0, 1) / sqrt(fan_in): w2's fan-in is d_ff.
        std = float(a["layers"]["w2"].std()) * tcfg.d_ff ** 0.5
        assert 0.8 < std < 1.2

    def test_params_from_numpy_keeps_tree_and_rounds_matrices(self):
        jparams, tparams = both_params(CONFIGS["dense"][0])
        for name in MATRICES:
            leaf = tparams["layers"][name]
            assert leaf.dtype == torch.bfloat16
            want = np.asarray(jparams["layers"][name].astype(jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(leaf.float().numpy(), want)
        assert tparams["embed"].dtype == torch.float32
        np.testing.assert_array_equal(tparams["embed"].numpy(), np.asarray(jparams["embed"]))


class TestRope:
    def test_tables_and_rotation_match(self):
        rng = np.random.RandomState(0)
        pos = np.array([0, 3, 17, 31], np.int32)
        x = rng.randn(2, 4, 3, 8).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16)
        want = jb.rope_apply(jx, jb.rope_tables(jnp.asarray(pos), 8))
        got = tb.rope_apply(
            torch.tensor(x).to(torch.bfloat16), tb.rope_tables(torch.tensor(pos), 8)
        )
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=2 ** -7, atol=2 ** -7
        )

    def test_odd_head_dim_rejected(self):
        with pytest.raises(ValueError, match="even d_head"):
            tb.rope_tables(torch.arange(4), 7)


class TestForward:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_logits_match_reference_forward(self, name):
        jcfg, tcfg = CONFIGS[name]
        jparams, tparams = both_params(jcfg)
        tokens = np.random.RandomState(1).randint(0, jcfg.vocab, (2, jcfg.seq)).astype(np.int32)
        want = np.asarray(jb.forward(jparams, jnp.asarray(tokens), jcfg))
        got = tb.forward(tparams, torch.tensor(tokens), tcfg)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert_logits_close(got.numpy(), want)

    def test_partial_sequence_rejected(self):
        _, tcfg = CONFIGS["dense"]
        params = tb.init_params(tcfg, device="cpu")
        with pytest.raises(ValueError, match="full sequences"):
            tb.forward(params, torch.zeros((1, 5), dtype=torch.int32), tcfg)

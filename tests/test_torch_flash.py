"""The port's flash attention (tpu_dra_torch/parallel/flash.py,
kernels/flash_attn.py, ring.py) against the reference's
(tpu_dra/parallel/flash.py run in Pallas interpret mode, as its own tests
run it, and ring.reference_attention), on the same numpy inputs.

On the CPU the port's forward is its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py).

Tolerances: f32 ``atol = 1e-5`` (the same f32 online softmax, summed in
another order); bf16 ``atol = 3e-2`` (the reference's own bf16 tolerance
in tests/test_flash.py: the two round their bf16 outputs apart by up to
an ulp).  Gradients in f32 to ``1e-5``: both differentiate the same
oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tpu_dra.parallel.flash import flash_attention as jax_flash
from tpu_dra.parallel.ring import reference_attention as jax_reference
from tpu_dra_torch.parallel import flash, ring
from tpu_dra_torch.parallel.kernels import flash_attn

torch.set_num_threads(2)

B, S, H, D = 2, 64, 2, 8
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5), "bf16": (torch.bfloat16, jnp.bfloat16, 3e-2)}
# (causal, block_q, block_k): the tiling of the reference's grid, square
# and uneven both ways (partial diagonal overlap).
TILINGS = {
    "causal": (True, 16, 16),
    "full": (False, 16, 16),
    "bq32_bk8": (True, 32, 8),
    "bq8_bk32": (True, 8, 32),
}
ENTRIES = {"plain": flash_attn.flash_attention_plain, "entry": flash.flash_attention}


def make_qkv(seed=0, s=S, d=D):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, s, H, d).astype(np.float32) for _ in range(3))


def to_jax(arrays, dtype):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


def to_torch(arrays, dtype, requires_grad=False):
    return tuple(torch.tensor(a).to(dtype).requires_grad_(requires_grad) for a in arrays)


class TestForward:
    @pytest.mark.parametrize("entry", sorted(ENTRIES))
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("tiling", sorted(TILINGS))
    def test_matches_reference_kernel(self, tiling, dtype, entry):
        causal, bq, bk = TILINGS[tiling]
        tdt, jdt, atol = DTYPES[dtype]
        arrays = make_qkv(seed=len(tiling))
        want = np.asarray(jax_flash(*to_jax(arrays, jdt), causal, bq, bk, True), np.float32)
        got = ENTRIES[entry](*to_torch(arrays, tdt), causal, bq, bk)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().float().numpy(), want, atol=atol)

    def test_strided_views_of_one_qkv_tensor(self):
        rng = np.random.RandomState(5)
        qkv = rng.randn(B, S, 3, H, D).astype(np.float32)
        want = np.asarray(jax_flash(*(jnp.asarray(qkv[:, :, i]) for i in range(3)), True, 16, 16, True))
        t = torch.tensor(qkv)
        got = flash.flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2], True, 16, 16)
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    @pytest.mark.parametrize("entry", sorted(ENTRIES))
    def test_indivisible_blocks_rejected(self, entry):
        q, k, v = to_torch(make_qkv(), torch.float32)
        with pytest.raises(ValueError, match="must divide"):
            ENTRIES[entry](q, k, v, True, 48, 16)

    def test_other_dtypes_and_mixed_devices_rejected(self):
        q, k, v = to_torch(make_qkv(), torch.float16)
        with pytest.raises(TypeError, match="dtype"):
            flash.flash_attention(q, k, v)
        q, k, v = to_torch(make_qkv(), torch.float32)
        with pytest.raises(ValueError, match="all on the CPU"):
            flash_attn.flash_attention_forward(q, k.to("meta"), v, True, 16, 16)

    def test_cpu_tensors_leave_the_launch_count(self):
        before = flash_attn.flash_attention_forward.launches
        q, k, v = to_torch(make_qkv(), torch.bfloat16)
        flash.flash_attention(q, k, v, True, 16, 16)
        assert flash_attn.flash_attention_forward.launches == before


class TestReferenceAttention:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference_oracle(self, causal, dtype):
        tdt, jdt, atol = DTYPES[dtype]
        arrays = make_qkv(seed=3)
        want = np.asarray(jax_reference(*to_jax(arrays, jdt), causal=causal), np.float32)
        got = ring.reference_attention(*to_torch(arrays, tdt), causal=causal)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def reference_grads(arrays, g, causal):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal, 16, 16, True) * g)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(*to_jax(arrays, jnp.float32))]


class TestGradients:
    @pytest.mark.parametrize("causal", [True, False])
    def test_match_reference_gradients(self, causal):
        arrays = make_qkv(seed=7)
        g = np.random.RandomState(8).randn(B, S, H, D).astype(np.float32)
        qkv = to_torch(arrays, torch.float32, requires_grad=True)
        out = flash.flash_attention(*qkv, causal, 16, 16)
        got = torch.autograd.grad(out, qkv, torch.tensor(g))
        for name, a, b in zip("qkv", got, reference_grads(arrays, g, causal)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=f"d{name}")

    def test_composes_with_checkpoint(self):
        arrays = make_qkv(seed=9)
        g = np.random.RandomState(10).randn(B, S, H, D).astype(np.float32)

        def run(*qkv):
            return flash.flash_attention(*qkv, True, 16, 16) * 2.0

        plain_in = to_torch(arrays, torch.float32, requires_grad=True)
        plain = torch.autograd.grad(run(*plain_in), plain_in, torch.tensor(g))
        remat_in = to_torch(arrays, torch.float32, requires_grad=True)
        out = checkpoint(run, *remat_in, use_reentrant=False)
        remat = torch.autograd.grad(out, remat_in, torch.tensor(g))
        want = reference_grads(arrays, 2.0 * g, True)
        for a, b, w in zip(plain, remat, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            np.testing.assert_allclose(b.numpy(), w, atol=1e-5)

"""The port's paged attention (tpu_dra_torch/parallel/kernels/paged_attn.py):
the plain PyTorch version against the reference's Pallas kernel (run by
the Pallas interpreter on the CPU, as tests/test_kernels.py runs it) and
against the gather path's dense oracle; masked tails; the wrapper's
dispatch.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.

Tolerance ``atol = rtol = 2e-2`` (tests/test_kernels.py's): bf16 outputs
whose f32 sums run in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra.parallel.kernels import paged_attention as jax_paged_attention
from tpu_dra_torch.parallel.kernels import paged_attention, paged_attention_plain

torch.set_num_threads(2)

TOL = 2e-2


def _dense_reference(q, k_pool, v_pool, table, pos):
    """The gather path's exact math (`paged._PagedKV.read` + the dense
    masked einsums of `decode._decode_block`), as a standalone oracle."""
    B, NW = table.shape
    W = k_pool.shape[1]
    K = k_pool.shape[-1]
    k_all = k_pool[table].reshape(B, NW * W, *k_pool.shape[2:])
    v_all = v_pool[table].reshape(B, NW * W, *v_pool.shape[2:])
    scores = jnp.einsum("bshk,bthk->bhst", q[:, None], k_all) / (K**0.5)
    slots = jnp.arange(NW * W)[None, :]
    mask = (slots <= pos[:, None])[:, None, None, :]
    scores = jnp.where(mask, scores.astype(jnp.float32), -1e30)
    probs = jnp.exp(scores - scores.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(jnp.bfloat16)
    return jnp.einsum("bhst,bthk->bshk", probs, v_all)[:, 0]


def _case(seed, nb, w, h, k, table, pos):
    """numpy inputs: bf16-exact pools and queries, int32 table and pos."""
    rng = np.random.RandomState(seed)

    def bf16(shape):
        return np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16), np.float32)

    return (
        bf16((len(table), h, k)), bf16((nb, w, h, k)), bf16((nb, w, h, k)),
        np.asarray(table, np.int32), np.asarray(pos, np.int32),
    )


def _jax(case):
    q, kp, vp, table, pos = case
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
            jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(pos))


def _torch(case):
    q, kp, vp, table, pos = case
    bf16 = torch.bfloat16
    return (torch.tensor(q, dtype=bf16), torch.tensor(kp, dtype=bf16),
            torch.tensor(vp, dtype=bf16), torch.tensor(table), torch.tensor(pos))


# Tables mix real blocks, scratch-0 tail columns and partial last blocks;
# positions cover the first slot, mid-block, a block boundary and the
# table's last slot.
CASES = {
    "mixed": (0, 11, 4, 4, 8, [[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0]], [0, 15, 6]),
    "boundaries": (1, 12, 4, 2, 16, [[1, 0, 0], [2, 3, 0], [4, 5, 6], [7, 8, 9]], [3, 4, 11, 5]),
    "wide_block": (2, 6, 8, 4, 8, [[1, 2], [3, 0], [4, 5]], [15, 0, 9]),
}


class TestPlainVersion:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_reference_kernel_and_dense_oracle(self, name):
        case = _case(*CASES[name])
        want_kernel = np.asarray(jax_paged_attention(*_jax(case)), np.float32)
        want_dense = np.asarray(_dense_reference(*_jax(case)), np.float32)
        got = paged_attention_plain(*_torch(case))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want_kernel.shape
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, want_dense, atol=TOL, rtol=TOL)

    def test_masked_tail_blocks_do_not_leak(self):
        """Positions past pos[b] — whole scratch columns included — add
        nothing: poisoning them changes no output bit."""
        q, kp, vp, table, pos = _torch(_case(3, 8, 4, 2, 8, [[1, 2, 0, 0]], [5]))
        base = paged_attention_plain(q, kp, vp, table, pos)
        pk, pv = kp.clone(), vp.clone()
        pk[0], pv[0] = 99.0, -55.0  # scratch
        pk[2, 2:], pv[2, 2:] = 77.0, 33.0  # the tail of the last live block
        assert torch.equal(paged_attention_plain(q, pk, pv, table, pos), base)

    def test_nothing_visible_gives_zeros(self):
        q, kp, vp, table, _ = _torch(_case(4, 4, 4, 2, 8, [[1, 2]], [0]))
        out = paged_attention_plain(q, kp, vp, table, torch.tensor([-1], dtype=torch.int32))
        assert torch.equal(out, torch.zeros_like(out))


class TestWrapper:
    def test_cpu_tensors_run_the_plain_version_uncounted(self):
        args = _torch(_case(*CASES["mixed"]))
        before = paged_attention.launches
        assert torch.equal(paged_attention(*args), paged_attention_plain(*args))
        assert paged_attention.launches == before

    def test_int8_pools_rejected(self):
        q, kp, vp, table, pos = _torch(_case(*CASES["mixed"]))
        int8 = {"q": kp.to(torch.int8), "s": torch.ones(kp.shape[:-1] + (1,))}
        with pytest.raises(TypeError, match="int8"):
            paged_attention(q, int8, vp, table, pos)
        with pytest.raises(TypeError, match="int8"):
            paged_attention_plain(q, kp, int8, table, pos)

    def test_mixed_devices_rejected(self):
        q, kp, vp, table, pos = _torch(_case(*CASES["mixed"]))
        with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
            paged_attention(q, kp.to("meta"), vp, table, pos)

    @pytest.mark.parametrize(
        "which,shape", [("q", (3, 4, 4)), ("table", (3,)), ("pos", (2,))]
    )
    def test_bad_shapes_rejected(self, which, shape):
        args = dict(zip(("q", "k_pool", "v_pool", "table", "pos"), _torch(_case(*CASES["mixed"]))))
        args[which] = torch.zeros(shape, dtype=args[which].dtype)
        with pytest.raises(ValueError, match=which):
            paged_attention(**args)


"""The port's CUDA kernels on the card (tests marked ``cuda``; each skips
where torch sees no CUDA device).  This module imports neither JAX nor
the reference package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up.)  Each kernel is
held against its plain PyTorch version, which the CPU tests hold against
the reference; the engine's kernel path against its gather path, with
bf16 and with int8 pools and weights; the flash gradient against the
reference attention's.

Tolerances: paged kernel vs plain about one bf16 ulp of the value
(``atol = 2**-9``, ``rtol = 2**-7``): both sides read the same bf16 values
(an int8 element is dequantized to the same bf16 value on both) and round
f32 sums taken in another order; flash kernel vs plain the same one ulp
(both round one f32 result once), ``1e-5`` for f32 outputs; decode-step
logits within 2 bf16 ulps of the gather path's magnitude (``rtol =
2**-6``, ``atol = 2**-6 * max|ref|``); flash gradients ``1e-5`` (both
differentiate the same oracle)."""

import dataclasses

import pytest
import torch

from tpu_dra_torch.parallel import burnin, flash, paged, quant, ring
from tpu_dra_torch.parallel.kernels import (
    flash_attention_forward,
    flash_attention_plain,
    paged_attention,
    paged_attention_plain,
)
from tpu_dra_torch.parallel.kernels.paged_attn import cluster_occupancy
from tpu_dra_torch.parallel.mfu import chip_sized_config
from tpu_dra_torch.parallel.serve import ServeEngine

PAGED_TOL = {"atol": 2 ** -9, "rtol": 2 ** -7}

# (B, H, K, W, NW, positions): the head widths the kernel takes, tables
# with scratch tails, positions at the first slot, mid-block, a block
# boundary and the table's last slot.
CASES = {
    "k8": (3, 4, 8, 4, 4, [0, 15, 6]),
    "k64": (3, 4, 64, 4, 3, [0, 5, 11]),
    "k128": (8, 32, 128, 128, 5, [0, 63, 127, 128, 200, 383, 511, 639]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _case(dev, B, H, K, W, NW, pos, seed=0):
    g = torch.Generator().manual_seed(seed)
    nb = sum(p // W + 1 for p in pos) + 1
    k_pool = torch.randn((nb, W, H, K), generator=g).to(torch.bfloat16)
    v_pool = torch.randn((nb, W, H, K), generator=g).to(torch.bfloat16)
    q = torch.randn((B, H, K), generator=g).to(torch.bfloat16)
    table = torch.zeros((B, NW), dtype=torch.int32)
    blocks = iter(torch.randperm(nb - 1, generator=g).tolist())
    for b, p in enumerate(pos):
        for j in range(p // W + 1):
            table[b, j] = next(blocks) + 1
    args = (q, k_pool, v_pool, table, torch.tensor(pos, dtype=torch.int32))
    return tuple(t.to(dev) for t in args)


@pytest.mark.cuda
class TestKernel:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_plain_and_counts_its_launch(self, name, cuda):
        args = _case(cuda, *CASES[name])
        want = paged_attention_plain(*args).float()
        before = paged_attention.launches
        got = paged_attention(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want, **PAGED_TOL)

    def test_masked_tail_and_scratch_never_read(self, cuda):
        q, kp, vp, table, pos = _case(cuda, *CASES["k64"])
        base = paged_attention(q, kp, vp, table, pos)
        W = kp.shape[1]
        kp, vp = kp.clone(), vp.clone()
        kp[0], vp[0] = float("nan"), float("nan")  # scratch: never read
        for b, p in enumerate(pos.tolist()):
            blk = int(table[b, p // W])
            kp[blk, p % W + 1:], vp[blk, p % W + 1:] = float("inf"), float("nan")
        assert torch.equal(paged_attention(q, kp, vp, table, pos), base)

    def test_rejects_what_it_does_not_take(self, cuda):
        q, kp, vp, table, pos = _case(cuda, *CASES["k64"])
        with pytest.raises(TypeError, match="table"):
            paged_attention(q, kp, vp, table.long(), pos)
        with pytest.raises(TypeError, match="q must be"):
            paged_attention(q.float(), kp, vp, table, pos)
        with pytest.raises(ValueError, match="contiguous"):
            paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kp, vp, table, pos)
        with pytest.raises(ValueError, match="takes K"):
            q2, kp2, vp2, t2, p2 = _case(cuda, 2, 2, 24, 4, 2, [3, 5])
            paged_attention(q2, kp2, vp2, t2, p2)


def _int8(pool):
    """A pool, one layer's or stacked, as the int8 pair the engine
    stores: one scale per (position, head), over d_head."""
    return quant.quantize_tensor(pool, (pool.dim() - 1,))


# Rows the kernel's cluster of 8 blocks splits unevenly or not at all:
# fewer visible positions than blocks (pos 0, 1 and 7), a row at the
# table's last slot, a row with nothing visible (pos -1), and head counts
# that fill a block with 1, 2 or 4 heads.
EDGE_CASES = {
    "k64": (5, 4, 64, 4, 3, [0, 1, 7, 11, -1]),
    "k64_h3": (4, 3, 64, 4, 3, [-1, 1, 7, 11]),
    "k64_h6": (4, 6, 64, 4, 3, [11, 0, -1, 7]),
    "k128": (6, 32, 128, 128, 5, [0, 1, 7, 639, -1, 300]),
}


@pytest.mark.cuda
class TestKernelEdges:
    @pytest.mark.parametrize("form", ["bf16", "int8"])
    @pytest.mark.parametrize("name", sorted(EDGE_CASES))
    def test_matches_plain_repeats_and_zeros_empty_rows(self, name, form, cuda):
        q, kp, vp, table, pos = _case(cuda, *EDGE_CASES[name])
        if form == "int8":
            kp, vp = _int8(kp), _int8(vp)
        want = paged_attention_plain(q, kp, vp, table, pos).float()
        got = paged_attention(q, kp, vp, table, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **PAGED_TOL)
        assert torch.equal(paged_attention(q, kp, vp, table, pos), got)
        empty = pos < 0
        assert empty.any() and torch.equal(got[empty], torch.zeros_like(got[empty]))

    def test_engine_shapes_fit_the_card_in_one_wave(self, cuda):
        clusters, resident = cluster_occupancy(8, 32, 128, 128, 5)
        assert 0 < clusters <= resident


@pytest.mark.cuda
class TestInt8Kernel:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_plain_and_counts_its_launch(self, name, cuda):
        q, kp, vp, table, pos = _case(cuda, *CASES[name])
        args = (q, _int8(kp), _int8(vp), table, pos)
        want = paged_attention_plain(*args).float()
        before = paged_attention.launches
        got = paged_attention(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, **PAGED_TOL)

    def test_nan_scales_in_scratch_and_tails_never_read(self, cuda):
        q, kp, vp, table, pos = _case(cuda, *CASES["k64"])
        k8, v8 = _int8(kp), _int8(vp)
        base = paged_attention(q, k8, v8, table, pos)
        W = kp.shape[1]
        for pool in (k8, v8):
            pool["q"][0], pool["s"][0] = 127, float("nan")  # scratch
            for b, p in enumerate(pos.tolist()):
                blk = int(table[b, p // W])
                pool["q"][blk, p % W + 1:], pool["s"][blk, p % W + 1:] = 127, float("nan")
        assert torch.equal(paged_attention(q, k8, v8, table, pos), base)

    def test_rejects_mixed_pairs_and_wrong_scales(self, cuda):
        q, kp, vp, table, pos = _case(cuda, *CASES["k64"])
        with pytest.raises(TypeError, match="not one of each"):
            paged_attention(q, _int8(kp), vp, table, pos)
        bad = _int8(kp)
        bad["s"] = bad["s"][..., 0]
        with pytest.raises(ValueError, match=r"k_pool\['s'\]"):
            paged_attention(q, bad, _int8(vp), table, pos)
        half = {"q": _int8(kp)["q"], "s": _int8(kp)["s"].half()}
        with pytest.raises(TypeError, match="float32"):
            paged_attention(q, half, _int8(vp), table, pos)


_CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32)


def _step_both_backends(cuda, kv_int8):
    """One decode step of a random pool through the gather and kernel
    backends (int8 weights with an int8 pool)."""
    params = burnin.init_params(_CFG, device=cuda)
    if kv_int8:
        params = quant.quantize_params(params)
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (_CFG.n_layers, 12, 4, _CFG.n_heads, _CFG.d_head)
    pool = {n: torch.randn(shape, generator=g, device=cuda) for n in ("k", "v")}
    pool = {n: _int8(a) if kv_int8 else a.to(torch.bfloat16) for n, a in pool.items()}
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7], [8, 0, 0, 0]], dtype=torch.int32,
                         device=cuda)
    pos = torch.tensor([9, 15, 0], dtype=torch.int32, device=cuda)
    tok = torch.tensor([3, 9, 60], dtype=torch.int32, device=cuda)
    out = {}
    for backend in ("gather", "cuda"):
        out[backend], _ = paged.paged_decode_step_rows(
            params, tok, pool, table, pos, _CFG, backend=backend
        )
    ref = out["gather"]
    torch.testing.assert_close(
        out["cuda"], ref, rtol=2 ** -6, atol=2 ** -6 * ref.abs().max().item()
    )


def _engine_launches(params, kv_int8):
    """A small engine drains four requests, one kernel launch a layer a
    step, every block freed."""
    eng = ServeEngine(params, _CFG, slots=2, prompt_slots=8, max_new_cap=6, kv_int8=kv_int8)
    assert eng.attn_backend == "cuda"  # auto on a CUDA engine
    for length, budget in ((8, 6), (3, 2), (5, 4), (1, 6)):
        eng.submit(list(range(1, length + 1)), budget)
    before = paged_attention.launches
    done = eng.run()
    assert paged_attention.launches - before == eng.device_steps * _CFG.n_layers
    assert [len(r.tokens) for r in sorted(done, key=lambda r: r.id)] == [6, 2, 4, 6]
    assert all(r.finish_reason == "budget" for r in done)
    assert eng.kv_stats()["blocks_free"] == eng.kv_stats()["blocks_total"] - 1


@pytest.mark.cuda
class TestEngine:
    def test_kernel_step_matches_gather_step(self, cuda):
        _step_both_backends(cuda, kv_int8=False)

    def test_int8_kernel_step_matches_gather_step(self, cuda):
        _step_both_backends(cuda, kv_int8=True)

    def test_engine_launches_once_per_layer_and_step(self, cuda):
        _engine_launches(burnin.init_params(_CFG, device=cuda), kv_int8=False)

    def test_int8_engine_launches_once_per_layer_and_step(self, cuda):
        params = quant.quantize_params(burnin.init_params(_CFG, device=cuda))
        _engine_launches(params, kv_int8=True)


# (b, s, h, d, block): both head widths the kernel takes, a sequence that
# is not a multiple of its 64-row tiles, and the reference's block sizes.
FLASH_CASES = {
    "d64": (2, 192, 3, 64, 64),
    "d128": (2, 256, 4, 128, 128),
    "d128_ragged": (1, 200, 2, 128, 8),
}
FLASH_TOL = {torch.bfloat16: (2 ** -9, 2 ** -7), torch.float32: (1e-5, 1e-5)}  # (atol, rtol)
# (b, s, h, d, block): sequences that end inside a 64-row tile (200, 1000)
# or one past a tile edge (64k + 1), at both head widths; the block sizes
# are the plain version's tiling (they must divide s).
FLASH_EDGE_CASES = {
    "s200_d64": (1, 200, 2, 64, 8),
    "s200_d128": (1, 200, 2, 128, 8),
    "s1000_d128": (1, 1000, 2, 128, 8),
    "s129_d64": (2, 129, 2, 64, 43),
    "s129_d128": (2, 129, 2, 128, 43),
    "s65_d128": (1, 65, 3, 128, 13),
}


def _qkv(dev, b, s, h, d, dtype=torch.bfloat16, seed=0):
    """q, k and v as strided views of one (b, s, 3, h, d) tensor, the
    layout of the model's qkv product."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g).to(dev, dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
class TestFlashKernel:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
    @pytest.mark.parametrize("name", sorted(FLASH_CASES))
    def test_matches_plain_and_counts_its_launch(self, name, causal, dtype, cuda):
        b, s, h, d, block = FLASH_CASES[name]
        q, k, v = _qkv(cuda, b, s, h, d, dtype)
        want = flash_attention_plain(q, k, v, causal, block, block).float()
        before = flash_attention_forward.launches
        got = flash_attention_forward(q, k, v, causal, block, block)
        torch.cuda.synchronize()
        assert flash_attention_forward.launches == before + 1
        assert got.dtype == dtype and got.is_contiguous() and got.shape == q.shape
        atol, rtol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)

    @pytest.mark.parametrize("layout", ["views", "contiguous"])
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
    @pytest.mark.parametrize("name", sorted(FLASH_EDGE_CASES))
    def test_bf16_edges_match_plain_and_repeat(self, name, causal, layout, cuda):
        b, s, h, d, block = FLASH_EDGE_CASES[name]
        q, k, v = _qkv(cuda, b, s, h, d, seed=7)
        if layout == "contiguous":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        want = flash_attention_plain(q, k, v, causal, block, block).float()
        got = flash_attention_forward(q, k, v, causal, block, block)
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
        assert torch.equal(flash_attention_forward(q, k, v, causal, block, block), got)

    @pytest.mark.parametrize("d", [64, 128])
    def test_nan_future_tiles_never_read_at_a_ragged_length(self, d, cuda):
        q, k, v = _qkv(cuda, 2, 200, 3, d, seed=8)
        base = flash_attention_forward(q, k, v, True, 8, 8)
        k, v = k.clone(), v.clone()
        k[:, 128:], v[:, 128:] = float("nan"), float("nan")
        assert torch.equal(flash_attention_forward(q, k, v, True, 8, 8)[:, :128], base[:, :128])

    def test_contiguous_inputs_match_views(self, cuda):
        q, k, v = _qkv(cuda, 2, 256, 4, 128)
        views = flash_attention_forward(q, k, v)
        dense = flash_attention_forward(q.contiguous(), k.contiguous(), v.contiguous())
        assert torch.equal(views, dense)

    def test_future_tiles_never_read(self, cuda):
        q, k, v = _qkv(cuda, 2, 256, 4, 128)
        base = flash_attention_forward(q, k, v)
        k, v = k.clone(), v.clone()
        k[:, 128:], v[:, 128:] = float("nan"), float("inf")
        assert torch.equal(flash_attention_forward(q, k, v)[:, :128], base[:, :128])

    def test_rejects_what_it_does_not_take(self, cuda):
        q, k, v = _qkv(cuda, 2, 128, 2, 64)
        with pytest.raises(TypeError, match="dtype"):
            flash_attention_forward(q.half(), k.half(), v.half())
        swapped = torch.randn((2, 128, 64, 2), device=cuda, dtype=torch.bfloat16).transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous head"):
            flash_attention_forward(swapped, swapped, swapped)
        with pytest.raises(ValueError, match="takes d"):
            flash_attention_forward(*_qkv(cuda, 2, 128, 2, 32))
        with pytest.raises(ValueError, match="all on the CPU"):
            flash_attention_forward(q, k.cpu(), v)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
    def test_gradients_match_reference_attention(self, dtype, cuda):
        g = torch.randn((2, 512, 8, 128), device=cuda, dtype=dtype)
        grads = []
        for fn in (flash.flash_attention, ring.reference_attention):
            qkv = [t.detach().requires_grad_() for t in _qkv(cuda, 2, 512, 8, 128, dtype, seed=4)]
            grads.append(torch.autograd.grad(fn(*qkv), qkv, g))
        for got, want in zip(*grads):
            torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=0)


@pytest.mark.cuda
class TestFlashTraining:
    def test_full_width_step_launches_twice_per_layer(self, cuda):
        cfg = dataclasses.replace(chip_sized_config(80), n_layers=2, flash_attention=True)
        step, state = burnin.make_train_step(cfg, device=cuda)
        tokens = burnin.sample_tokens(cfg, device=cuda)
        before = flash_attention_forward.launches
        state, loss = step(state, tokens)
        # One launch in the forward and one in the checkpoint's recompute.
        assert flash_attention_forward.launches - before == 2 * cfg.n_layers
        assert torch.isfinite(loss)

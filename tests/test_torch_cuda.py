"""The port's CUDA kernels on the card (tests marked ``cuda``; each skips
where torch sees no CUDA device).  This module imports neither JAX nor
the reference package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up.)  Each kernel is
held against its plain PyTorch version, which the CPU tests hold against
the reference; the engine's kernel path against its gather path, with
bf16 and with int8 pools and weights; the flash gradient against the
reference attention's; the kernel over tables whose rows share blocks
(the prefix cache's); the engine with the prefix cache on; Threefry on
the card bitwise against the CPU's; the sampled engine's three
schedulings; one greedy speculative run against `make_generate`; the
flash kernel at the families' small head widths; the kernel rank by
rank over tp head slices and over Ulysses' head-swapped views (bitwise
one launch over every head) and the ring's one-rank fold and backward against the reference attention; the
prefetch onto the
card (order, contents, a side stream and an event wait a batch) and a
checkpoint's bitwise round trip and resume on the card.

Tolerances: paged kernel vs plain about one bf16 ulp of the value
(``atol = 2**-9``, ``rtol = 2**-7``): both sides read the same bf16 values
(an int8 element is dequantized to the same bf16 value on both) and round
f32 sums taken in another order; flash kernel vs plain the same one ulp
(both round one f32 result once), ``1e-5`` for f32 outputs; decode-step
logits within 2 bf16 ulps of the gather path's magnitude (``rtol =
2**-6``, ``atol = 2**-6 * max|ref|``); flash gradients ``1e-5`` (both
differentiate the same oracle); sampled runs and speculative tokens equal
(same card, same batch shape: the same products) or, across batch
shapes, equal up to a near-tie of ``2**-6 * max|logit|``."""

import dataclasses

import pytest
import torch

from tpu_dra_torch.parallel import (
    burnin,
    ckpt,
    data,
    decode,
    flash,
    paged,
    prng,
    quant,
    ring,
    speculative,
    spmd,
)
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


# Rows whose tables start with the same blocks and then diverge, as the
# prefix cache leaves them: (B, H, K, W, NW, shared blocks, positions),
# every position past the shared blocks.
ALIASED_CASES = {
    "k64": (4, 4, 64, 4, 4, 2, [8, 9, 12, 15]),
    "k128": (8, 32, 128, 128, 5, 3, [384, 400, 447, 500, 511, 512, 600, 639]),
}


def _aliased_case(dev, B, H, K, W, NW, shared, pos, seed=0):
    g = torch.Generator().manual_seed(seed)
    nb = shared + sum(p // W + 1 - shared for p in pos) + 1
    k_pool = torch.randn((nb, W, H, K), generator=g).to(torch.bfloat16)
    v_pool = torch.randn((nb, W, H, K), generator=g).to(torch.bfloat16)
    q = torch.randn((B, H, K), generator=g).to(torch.bfloat16)
    blocks = iter((torch.randperm(nb - 1, generator=g) + 1).tolist())
    common = [next(blocks) for _ in range(shared)]
    table = torch.zeros((B, NW), dtype=torch.int32)
    for b, p in enumerate(pos):
        table[b, :shared] = torch.tensor(common)
        for j in range(shared, p // W + 1):
            table[b, j] = next(blocks)
    args = (q, k_pool, v_pool, table, torch.tensor(pos, dtype=torch.int32))
    return tuple(t.to(dev) for t in args)


@pytest.mark.cuda
class TestKernelOverAliasedTables:
    @pytest.mark.parametrize("form", ["bf16", "int8"])
    @pytest.mark.parametrize("name", sorted(ALIASED_CASES))
    def test_matches_plain_and_repeats(self, name, form, cuda):
        q, kp, vp, table, pos = _aliased_case(cuda, *ALIASED_CASES[name])
        if form == "int8":
            kp, vp = _int8(kp), _int8(vp)
        want = paged_attention_plain(q, kp, vp, table, pos).float()
        got = paged_attention(q, kp, vp, table, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **PAGED_TOL)
        assert torch.equal(paged_attention(q, kp, vp, table, pos), got)


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
    assert eng.kv_block_stats["blocks_free"] == eng.kv_block_stats["blocks_total"] - 1


def _prefix_engine_launches(params):
    """A cache-on engine drains a shared-prefix stream through the
    kernel: one launch a layer a step, aliases and COW copies made, the
    blocks left are the resident entries'."""
    eng = ServeEngine(params, _CFG, slots=2, prompt_slots=8, max_new_cap=5,
                      prefix_cache_slots=4)
    shared = [5, 9, 2, 7, 11, 3]
    for t in range(5):
        eng.submit(shared + [t + 1], 4)
    before = paged_attention.launches
    done = eng.run()
    assert paged_attention.launches - before == eng.device_steps * _CFG.n_layers
    assert [len(r.tokens) for r in done] == [4] * 5
    kv = eng.kv_block_stats
    assert kv["alias_blocks_total"] > 0 and kv["cow_blocks_total"] > 0
    held = {b for e in eng._prefix.export_blocks() for b in e["blocks"]}
    assert kv["blocks_allocated"] == len(held)


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

    def test_prefix_engine_launches_once_per_layer_and_step(self, cuda):
        _prefix_engine_launches(burnin.init_params(_CFG, device=cuda))


@pytest.mark.cuda
class TestSampling:
    def test_threefry_on_the_card_is_bitwise_the_cpus(self, cuda):
        seeds = torch.tensor([0, -1, 7, 2 ** 31 - 1], dtype=torch.int32)
        pos = torch.tensor([0, 5, 1023, 2 ** 31 - 1], dtype=torch.int32)
        ck = prng.fold_in(prng.key(seeds), pos)
        gk = prng.fold_in(prng.key(seeds.to(cuda)), pos.to(cuda))
        assert torch.equal(gk.cpu(), ck)
        tiny = torch.finfo(torch.float32).tiny
        for c, g, shape in ((ck, gk, (1000,)), (prng.key(3), prng.key(3).to(cuda), (4, 1001))):
            assert torch.equal(prng.bits(g, shape).cpu(), prng.bits(c, shape))
            assert torch.equal(prng.split(g, 7).cpu(), prng.split(c, 7))
            assert torch.equal(prng.uniform(g, shape, minval=tiny).cpu(),
                               prng.uniform(c, shape, minval=tiny))

    def test_sampled_engine_three_ways(self, cuda):
        """Continuous and fused ticks at 3 slots give the same tokens and
        logprobs (the same products); 2 slots the same tokens up to a
        near-tie; every run launches the kernel once a layer a step."""
        params = burnin.init_params(_CFG, device=cuda)
        reqs = [(list(range(1, n + 1)), b) for n, b in ((8, 6), (3, 5), (5, 4), (1, 6), (6, 2))]
        outs = {}
        for label, kw in (("continuous", dict(slots=3)),
                          ("tick", dict(slots=3, scheduling="tick", steps_per_tick=4)),
                          ("2 slots", dict(slots=2))):
            eng = ServeEngine(params, _CFG, prompt_slots=8, max_new_cap=6, temperature=0.8,
                              top_k=20, top_p=0.9, with_logprobs=True, **kw)
            ids = [eng.submit(p, b, seed=17 * i) for i, (p, b) in enumerate(reqs)]
            before = paged_attention.launches
            eng.run()
            assert paged_attention.launches - before == eng.device_steps * _CFG.n_layers
            outs[label] = [eng.request(i) for i in ids]
        assert [(r.tokens, r.logprobs) for r in outs["tick"]] == [
            (r.tokens, r.logprobs) for r in outs["continuous"]]
        for a, b in zip(outs["2 slots"], outs["continuous"]):
            assert len(a.tokens) == len(b.tokens)
            assert all(lp <= 0 for lp in a.logprobs)
            i = next((j for j in range(len(a.tokens)) if a.tokens[j] != b.tokens[j]), None)
            if i is not None:
                seq = torch.tensor([a.prompt + b.tokens[:i]], dtype=torch.int32, device=cuda)
                cache = decode.init_cache(_CFG, 1, device=cuda)
                row = decode.decode_forward(params, seq, cache, 0, _CFG)[0][0, -1]
                g = prng.gumbel(prng.fold_in(prng.key(b.seed), len(a.prompt) + i).to(cuda),
                                (_CFG.vocab,))
                z = row / 0.8 + g
                tol = 2 ** -6 * row.abs().max().item() / 0.8
                assert abs((z[a.tokens[i]] - z[b.tokens[i]]).item()) <= 2 * tol

    def test_speculative_greedy_equals_make_generate(self, cuda):
        params = burnin.init_params(_CFG, device=cuda)
        prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]],
                              dtype=torch.int32, device=cuda)
        want = decode.make_generate(_CFG, prompt_len=8, steps=12)(params, prompt)
        got, rounds, ok = speculative.make_generate_speculative(
            _CFG, prompt_len=8, steps=12, draft_layers=_CFG.n_layers, draft_len=3,
            with_stats=True)(params, prompt)
        assert bool(ok) and rounds <= 12
        for a, b in zip(got.tolist(), want.tolist()):
            i = next((j for j in range(len(a)) if a[j] != b[j]), None)
            if i is not None:  # the verify pass's products have another shape
                seq = torch.tensor([b[:i]], dtype=torch.int32, device=cuda)
                row = decode.decode_forward(params, seq, decode.init_cache(_CFG, 1, device=cuda),
                                            0, _CFG)[0][0, -1]
                assert (row[b[i]] - row[a[i]]).abs().item() <= 2 ** -5 * row.abs().max().item()


# (b, s, h, d, block): both head widths the kernel takes, a sequence that
# is not a multiple of its 64-row tiles, and the reference's block sizes.
FLASH_CASES = {
    "d16": (2, 192, 8, 16, 64),
    "d32_ragged": (1, 200, 4, 32, 8),
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

    @pytest.mark.parametrize("d", [16, 32, 64, 128])
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
            flash_attention_forward(*_qkv(cuda, 2, 128, 2, 48))
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


class _OneRank:
    """The place of the only rank on a one-rank ring (no process group)."""

    sizes, coords = {"model": 1}, {"model": 0}

    def size(self, axis):
        return 1

    def index(self, axis):
        return 0


@pytest.mark.cuda
class TestShardedFlash:
    @pytest.mark.parametrize("model", [2, 4, 8])
    def test_ranks_heads_equal_one_launch(self, model, cuda):
        """Each tp rank's launch on its own heads (contiguous, as its
        column-parallel product leaves them): concatenated, bitwise the
        launch over every head."""
        g = torch.Generator(device=cuda).manual_seed(9)
        qkv = torch.randn((2, 256, 3, 8, 128), generator=g, device=cuda).to(torch.bfloat16)
        whole = flash_attention_forward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        n = 8 // model
        before = flash_attention_forward.launches
        parts = []
        for r in range(model):
            local = qkv[:, :, :, r * n:(r + 1) * n].contiguous()
            parts.append(flash.flash_attention_sharded(local[:, :, 0], local[:, :, 1],
                                                       local[:, :, 2], {"model": model}))
        assert flash_attention_forward.launches - before == model
        assert torch.equal(torch.cat(parts, dim=2), whole)

    @pytest.mark.parametrize("model", [2, 4, 8])
    def test_ulysses_view_matches_plain_and_one_launch(self, model, cuda):
        """K2 on each rank's head-swapped view as Ulysses lays it out (the
        sequence blocks' qkv swapped by the all-to-all's own packing, q, k
        and v strided views of one (b, s, 3, h / model, d) tensor): within
        one bf16 ulp of the plain version, and the ranks' outputs
        concatenated over heads bitwise one launch over every head."""
        g = torch.Generator(device=cuda).manual_seed(12)
        qkv = torch.randn((2, 256, 3, 8, 128), generator=g, device=cuda).to(torch.bfloat16)
        whole = flash_attention_forward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        views = spmd.all_to_all_local(list(qkv.chunk(model, dim=1)), 3, 1)
        before = flash_attention_forward.launches
        parts = [flash_attention_forward(v[:, :, 0], v[:, :, 1], v[:, :, 2]) for v in views]
        assert flash_attention_forward.launches - before == model
        for v, part in zip(views, parts):
            assert v.shape == (2, 256, 3, 8 // model, 128) and v.is_contiguous()
            want = flash_attention_plain(v[:, :, 0], v[:, :, 1], v[:, :, 2])
            torch.testing.assert_close(part.float(), want.float(), **PAGED_TOL)
        assert torch.equal(torch.cat(parts, dim=2), whole)

    def test_ring_on_one_rank_matches_reference_attention(self, cuda):
        qkv = _qkv(cuda, 2, 256, 4, 64, torch.float32, seed=10)
        g = torch.randn((2, 256, 4, 64), device=cuda)
        outs = []
        for fn in (lambda *t: ring.ring_attention(*t, _OneRank(), "model"),
                   lambda *t: ring.reference_attention(*t, causal=True)):
            inputs = [t.detach().clone().requires_grad_() for t in qkv]
            out = fn(*inputs)
            outs.append([out.detach()] + list(torch.autograd.grad(out, inputs, g)))
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


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


@pytest.mark.cuda
class TestBurnin:
    CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=64,
                              batch=8)

    @pytest.mark.parametrize("size", [1, 3])
    def test_prefetch_order_contents_and_stream(self, size, cuda):
        host = [b for _, b in zip(range(6), data.synthetic_stream(self.CFG, seed=2))]
        pf = data.prefetch_to_device(iter(host), size=size, device=cuda)
        got = list(pf)
        assert len(got) == 6 and pf.waits == 6
        assert pf.stream is not None and pf.stream != torch.cuda.current_stream()
        for g, h in zip(got, host):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), h)

    def test_train_on_stream_learns(self, cuda):
        r = data.train_on_stream(burnin.BurninConfig(), steps=10, seed=1, device=cuda)
        assert r.ok, r.error

    def test_checkpoint_round_trip_and_resume(self, tmp_path, cuda):
        step, state = burnin.make_train_step(self.CFG, cuda)
        ckpt.save_state(tmp_path / "rt", state, step=1)
        restored = ckpt.restore_state(tmp_path / "rt", self.CFG, step=1, device=cuda)
        for a, b in zip(burnin._leaves(state[0]) + burnin._leaves(state[1]),
                        burnin._leaves(restored[0]) + burnin._leaves(restored[1])):
            assert b.device.type == "cuda" and torch.equal(a, b)
        _, full = ckpt.train_with_resume(self.CFG, tmp_path / "full", steps=4, device=cuda)
        _, first = ckpt.train_with_resume(self.CFG, tmp_path / "run", steps=2, device=cuda)
        final, second = ckpt.train_with_resume(self.CFG, tmp_path / "run", steps=2, device=cuda)
        assert final == 4 and first + second == full

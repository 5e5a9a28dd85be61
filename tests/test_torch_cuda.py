"""The port's CUDA kernel on the card (tests marked ``cuda``; each skips
where torch sees no CUDA device).  This module imports neither JAX nor
the reference package, so it also runs on a GPU host that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up.)  The kernel is held
against its plain PyTorch version, which the CPU tests hold against the
reference; the engine's kernel path against its gather path.

Tolerances: kernel vs plain ``atol = rtol = 2e-2`` (bf16 outputs whose
f32 sums run in another order); decode-step logits within 2 bf16 ulps of
the gather path's magnitude (``rtol = 2**-6``, ``atol = 2**-6 *
max|ref|``)."""

import pytest
import torch

from tpu_dra_torch.parallel import burnin, paged
from tpu_dra_torch.parallel.kernels import paged_attention, paged_attention_plain
from tpu_dra_torch.parallel.serve import ServeEngine

TOL = 2e-2

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
        torch.testing.assert_close(got.float(), want, atol=TOL, rtol=TOL)

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


_CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32)


@pytest.mark.cuda
class TestEngine:
    def test_kernel_step_matches_gather_step(self, cuda):
        params = burnin.init_params(_CFG, device=cuda)
        pool = paged.init_block_pool(_CFG, 12, 4, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(1)
        for leaf in pool.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
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

    def test_engine_launches_once_per_layer_and_step(self, cuda):
        params = burnin.init_params(_CFG, device=cuda)
        eng = ServeEngine(params, _CFG, slots=2, prompt_slots=8, max_new_cap=6)
        assert eng.attn_backend == "cuda"  # auto on a CUDA engine
        for length, budget in ((8, 6), (3, 2), (5, 4), (1, 6)):
            eng.submit(list(range(1, length + 1)), budget)
        before = paged_attention.launches
        done = eng.run()
        assert paged_attention.launches - before == eng.device_steps * _CFG.n_layers
        assert [len(r.tokens) for r in sorted(done, key=lambda r: r.id)] == [6, 2, 4, 6]
        assert all(r.finish_reason == "budget" for r in done)
        assert eng.kv_stats()["blocks_free"] == eng.kv_stats()["blocks_total"] - 1

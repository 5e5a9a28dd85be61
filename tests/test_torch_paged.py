"""The port's paged KV pool (tpu_dra_torch/parallel/paged.py) against the
reference (tpu_dra/parallel/paged.py): the per-row paged decode step on
both attention backends, the block-table prefill, the pool, and the
block allocator's bookkeeping.  Tolerance as stated in test_torch_burnin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, assert_logits_close, both_params
from tpu_dra.parallel import paged as jp
from tpu_dra_torch.parallel import paged as tp

torch.set_num_threads(2)


def _random_pool(cfg, nb, w, seed):
    """The same bf16 pool for both frameworks, from a numpy seed."""
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, nb, w, cfg.n_heads, cfg.d_head)
    leaves = {
        name: np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16), np.float32)
        for name in ("k", "v")
    }
    jpool = {n: jnp.asarray(a, jnp.bfloat16) for n, a in leaves.items()}
    tpool = {n: torch.tensor(a, dtype=torch.bfloat16) for n, a in leaves.items()}
    return jpool, tpool


def _assert_pools_close(tpool, jpool):
    for name in ("k", "v"):
        want = np.asarray(jpool[name], np.float32)
        np.testing.assert_allclose(
            tpool[name].float().numpy(), want,
            rtol=2 ** -6, atol=2 ** -6 * float(np.abs(want).max()),
        )


TABLE = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 0, 0, 0]], np.int32)
POS = np.array([9, 15, 0], np.int32)  # mid-block, last slot, first slot


class TestPagedDecodeStep:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    @pytest.mark.parametrize("backend,ref_backend", [("gather", "gather"), ("cuda", "pallas")])
    def test_step_matches_reference(self, name, backend, ref_backend):
        """One step through the block tables: the port's gather against
        the reference's gather, and the port's kernel route (its plain
        version on CPU tensors) against the reference's Pallas kernel in
        interpret mode.  Logits and the written pools agree."""
        jcfg, tcfg = CONFIGS[name]
        jparams, tparams = both_params(jcfg)
        jpool, tpool = _random_pool(jcfg, 12, 4, seed=3)
        tok = np.array([3, 9, 60], np.int32)
        want, jpool = jp.paged_decode_step_rows(
            jparams, jnp.asarray(tok), jpool, jnp.asarray(TABLE), jnp.asarray(POS), jcfg,
            backend=ref_backend,
        )
        got, tpool_out = tp.paged_decode_step_rows(
            tparams, torch.tensor(tok), tpool, torch.tensor(TABLE), torch.tensor(POS), tcfg,
            backend=backend,
        )
        assert tpool_out is tpool  # written in place
        assert_logits_close(got.numpy(), np.asarray(want))
        _assert_pools_close(tpool, jpool)

    def test_unknown_backend_rejected(self):
        jcfg, tcfg = CONFIGS["dense"]
        _, tparams = both_params(jcfg)
        pool = tp.init_block_pool(tcfg, 12, 4, device="cpu")
        with pytest.raises(ValueError, match="backend"):
            tp.paged_decode_step_rows(
                tparams, torch.tensor([1, 2, 3]), pool, torch.tensor(TABLE),
                torch.tensor(POS), tcfg, backend="pallas",
            )

    def test_writes_reject_wrong_widths(self):
        kv = tp._PagedKV(torch.tensor(TABLE), 4)
        buf = torch.zeros((12, 4, 4, 8), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="single-token"):
            kv.write(buf, torch.zeros((3, 2, 4, 8)), torch.tensor(POS))
        with pytest.raises(ValueError, match="fill one block"):
            kv.write(buf, torch.zeros((3, 3, 4, 8)), 4)


class TestPagedPrefill:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    @pytest.mark.parametrize("first_window", [0, 1])
    def test_prefill_matches_reference(self, name, first_window):
        """Two padded prompts through the block-table prefill, from a
        zeroed pool or on top of a resident first window: the last-position
        logits and the pool contents agree."""
        jcfg, tcfg = CONFIGS[name]
        jparams, tparams = both_params(jcfg)
        prompt_slots, w = 8, 4
        rng = np.random.RandomState(4)
        lens = np.array([7, 5], np.int32)
        prompt = np.zeros((2, prompt_slots), np.int32)
        for b, n in enumerate(lens):
            prompt[b, :n] = rng.randint(0, jcfg.vocab, n)
        table = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
        jpool, tpool = _random_pool(jcfg, 8, w, seed=5)
        want, jpool = jp.make_paged_prefill(jcfg, None, prompt_slots, w)(
            jparams, jnp.asarray(prompt), jnp.asarray(lens), jpool, jnp.asarray(table),
            first_window,
        )
        got, tpool = tp.make_paged_prefill(tcfg, prompt_slots, w)(
            tparams, torch.tensor(prompt), torch.tensor(lens), tpool, torch.tensor(table),
            first_window,
        )
        assert_logits_close(got.numpy(), np.asarray(want))
        _assert_pools_close(tpool, jpool)

    def test_bad_first_window_and_window_rejected(self):
        _, tcfg = CONFIGS["dense"]
        with pytest.raises(ValueError, match="prefix window"):
            tp.make_paged_prefill(tcfg, 8, 3)
        prefill = tp.make_paged_prefill(tcfg, 8, 4)
        with pytest.raises(ValueError, match="first_window"):
            prefill(None, torch.zeros((1, 8), dtype=torch.int32), None, None, None, 2)


class TestPool:
    def test_init_block_pool_matches_reference_layout(self):
        jcfg, tcfg = CONFIGS["dense"]
        want = jp.init_block_pool(jcfg, 5, 4)
        got = tp.init_block_pool(tcfg, 5, 4, device="cpu")
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == torch.bfloat16
            assert not got[name].any()

    @pytest.mark.parametrize("nb,w,match", [(1, 4, "scratch"), (4, 0, "block_size")])
    def test_bad_pool_rejected(self, nb, w, match):
        with pytest.raises(ValueError, match=match):
            tp.init_block_pool(CONFIGS["dense"][1], nb, w, device="cpu")


class TestBlockAllocator:
    def test_seeded_sequence_matches_reference(self):
        """One seeded alloc/ref/unref sequence through both allocators:
        handed-out ids, refcounts, free runs and stats agree at every
        step (the free list's LIFO, low-ids-first order included)."""
        rng = np.random.RandomState(6)
        ref_alloc, port_alloc = jp.BlockAllocator(17), tp.BlockAllocator(17)
        owned: "list[int]" = []
        for _ in range(200):
            op = rng.randint(3)
            if op == 0:
                n = int(rng.randint(0, 5))
                got, want = port_alloc.alloc(n), ref_alloc.alloc(n)
                assert got == want
                owned += got or []
            elif op == 1 and owned:
                blocks = [owned[i] for i in rng.choice(len(owned), min(2, len(owned)), replace=False)]
                port_alloc.ref(blocks)
                ref_alloc.ref(blocks)
                owned += blocks
            elif owned:
                b = owned.pop(int(rng.randint(len(owned))))
                port_alloc.unref([b])
                ref_alloc.unref([b])
            assert port_alloc.stats() == ref_alloc.stats()
            assert port_alloc.free_runs() == ref_alloc.free_runs()
            assert [port_alloc.refcount(b) for b in range(17)] == [
                ref_alloc.refcount(b) for b in range(17)
            ]

    def test_misuse_raises_like_the_reference(self):
        a = tp.BlockAllocator(4)
        with pytest.raises(RuntimeError, match="unowned"):
            a.unref([0])
        with pytest.raises(RuntimeError, match="unowned"):
            a.ref([2])
        with pytest.raises(ValueError, match="cannot allocate"):
            a.alloc(-1)
        assert a.alloc(4) is None and a.free_count == 3
        with pytest.raises(ValueError, match="scratch"):
            tp.BlockAllocator(1)


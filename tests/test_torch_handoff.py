"""Block-table handoff between two of the port's engines
(tpu_dra_torch/parallel/serve.py `handoff_out`/`handoff_in`) against two
of the reference's engines wired the same way (tpu_dra/parallel/serve.py;
the wiring of tpu_dra/parallel/disagg.py): a prefill engine admits each
request, the row moves after the tick that admitted it, and a decode
engine finishes it.

- ``alias``: both engines share one allocator and one pool dict, and the
  payload carries the block references (no device copy).
- ``dma``: separate pools; each block goes through a staging
  `HostBlockPool` and is written into fresh blocks of the decode pool.

Every tick the port's and the reference's counters are equal on both
engines and the reference's cross-engine conservation check holds on the
port's pair; tokens equal the reference's mono engine's up to a reference
near-tie (test_torch_prefix.assert_same_tokens)."""

import types

import pytest
import torch

from helpers import assert_kv_conserved
from test_torch_prefix import assert_same_tokens, dense  # noqa: F401
from tpu_dra.parallel import swap as jswap
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import serve as tserve
from tpu_dra_torch.parallel import swap as tswap

torch.set_num_threads(2)

# test_disagg.py's mixed stream: (prompt, max_new, priority).
STREAM = [
    ([5, 9, 2, 7, 11, 3], 5, 0),
    ([1, 2, 3], 5, 5),
    ([4, 4, 4, 4, 8, 1, 6, 2], 3, 0),
    ([7, 8], 4, 5),
    ([3, 1, 4, 1, 5, 9], 4, 0),
    ([2, 6], 3, 5),
]
SPEC = dict(prompt_slots=8, max_new_cap=5, prefix_window=2)


def _tiers(Engine, params, cfg, mode, hostpool, **kw):
    """A prefill engine (2 slots) and a decode engine (4 slots), sharing
    the decode engine's allocator and pool under alias; the staging pool
    under dma."""
    pre = Engine(params, cfg, slots=2, **SPEC, **kw)
    dec = Engine(params, cfg, slots=4, **SPEC, **kw)
    staging = None
    if mode == "alias":
        pre._balloc = dec._balloc
        pre._pool = dec._pool
    else:
        staging = hostpool.HostBlockPool(2 * pre._table_cols)
    return pre, dec, staging


def _handoff_all(pre, dec, mode, staging):
    for row in range(pre.slots):
        if pre._row_req[row] is not None:
            payload = pre.handoff_out(row, mode=mode, staging=staging)
            assert payload is not None
            dec.handoff_in(payload)


def _run_pair(dense, mode, stream=STREAM, max_ticks=100):
    """The stream through both pairs in lockstep; returns the port's
    Request objects (their ids change at handoff) and its engines."""
    jcfg, tcfg, jparams, tparams = dense
    jpre, jdec, jstage = _tiers(JaxEngine, jparams, jcfg, mode, jswap, attn_backend="gather")
    tpre, tdec, tstage = _tiers(tserve.ServeEngine, tparams, tcfg, mode, tswap, device="cpu")
    jreqs = [jpre.request(jpre.submit(p, b, priority=pr)) for p, b, pr in stream]
    treqs = [tpre.request(tpre.submit(p, b, priority=pr)) for p, b, pr in stream]
    shim = types.SimpleNamespace(tiers={"prefill": tpre, "decode": tdec}, handoff=mode,
                                 staging=tstage)
    for _ in range(max_ticks):
        if not (tpre.pending or tdec.pending or jpre.pending or jdec.pending):
            break
        for pre, dec, staging in ((jpre, jdec, jstage), (tpre, tdec, tstage)):
            # Under alias the reference's shared pool is a value that each
            # tick replaces: rebind it across (the port's is one dict).
            pre.tick()
            if mode == "alias":
                dec._pool = pre._pool
            _handoff_all(pre, dec, mode, staging)
            dec.tick()
            if mode == "alias":
                pre._pool = dec._pool
        for t, j in ((tpre, jpre), (tdec, jdec)):
            assert t.kv_block_stats == j.kv_block_stats
            assert (t.queue_depth, t.occupancy) == (j.queue_depth, j.occupancy)
        assert_kv_conserved(shim)
    assert all(r.done for r in treqs + jreqs), "pairs did not drain"
    for t, j in zip(treqs, jreqs):
        assert (t.finish_reason, t.handoffs, t.handoff_blocks, t.handoff_mode) == (
            j.finish_reason, j.handoffs, j.handoff_blocks, j.handoff_mode)
    return treqs, tpre, tdec


@pytest.fixture(scope="module")
def mono_tokens(dense):
    """The reference's mono engine over the stream."""
    jcfg, _, jparams, _ = dense
    eng = JaxEngine(jparams, jcfg, slots=2, attn_backend="gather", **SPEC)
    ids = [eng.submit(p, b, priority=pr) for p, b, pr in STREAM]
    eng.run()
    return [list(eng.request(i).tokens) for i in ids]


class TestHandoff:
    @pytest.mark.parametrize("mode", ["alias", "dma"])
    def test_tokens_match_the_reference_mono_engine(self, dense, mono_tokens, mode):
        jcfg, _, jparams, _ = dense
        treqs, tpre, tdec = _run_pair(dense, mode)
        assert_same_tokens(jcfg, jparams, [p for p, _, _ in STREAM],
                           [r.tokens for r in treqs], mono_tokens)
        assert all(r.handoffs == 1 and r.handoff_mode == mode for r in treqs)
        moved = sum(r.handoff_blocks for r in treqs)
        assert tpre.kv_block_stats["handoff_out_blocks_total"] == moved
        assert tdec.kv_block_stats["handoff_in_blocks_total"] == moved
        assert tdec.kv_block_stats[f"handoffs_{mode}_total"] == len(STREAM)

    def test_alias_handoff_copies_no_block(self, dense, monkeypatch):
        """Alias mode moves references: no block is copied or written,
        and the decode engine's alias counter grows by the moved blocks."""
        calls = []
        for name in ("copy_block", "write_block", "read_block"):
            real = getattr(tserve, name)
            monkeypatch.setattr(tserve, name,
                                lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
        treqs, _, tdec = _run_pair(dense, "alias")
        assert calls == []
        moved = sum(r.handoff_blocks for r in treqs)
        assert tdec.kv_block_stats["alias_blocks_total"] == moved
        assert tdec.kv_block_stats["alloc_blocks_total"] == 0

    def test_closing_one_engine_leaves_the_shared_pool(self, dense):
        _, tcfg, _, tparams = dense
        pre, dec, _ = _tiers(tserve.ServeEngine, tparams, tcfg, "alias", tswap, device="cpu")
        pre.submit([5, 9, 2, 7], 4)
        pre.tick()
        _handoff_all(pre, dec, "alias", None)
        pre.close()
        assert dec._pool is not None
        done = dec.run()
        assert len(done) == 1 and done[0].finish_reason == "budget"


class TestHandoffContract:
    def test_errors_follow_the_reference(self, dense):
        _, tcfg, _, tparams = dense
        eng = tserve.ServeEngine(tparams, tcfg, slots=1, prompt_slots=8, max_new_cap=4,
                                 prefix_window=2, device="cpu")
        with pytest.raises(ValueError, match="mode must be"):
            eng.handoff_out(0, mode="teleport")
        with pytest.raises(ValueError, match="requires a staging"):
            eng.handoff_out(0, mode="dma")
        with pytest.raises(ValueError, match="no in-flight request"):
            eng.handoff_out(0, mode="alias")

    def test_full_staging_defers_and_a_narrow_table_refuses(self, dense):
        _, tcfg, _, tparams = dense
        pre = tserve.ServeEngine(tparams, tcfg, slots=1, **SPEC, device="cpu")
        pre.submit([5, 9, 2, 7, 11, 3], 5)
        pre.tick()
        before = pre.kv_block_stats
        assert pre.handoff_out(0, mode="dma", staging=tswap.HostBlockPool(2)) is None
        assert pre.occupancy == 1 and pre.kv_block_stats == before  # untouched
        payload = pre.handoff_out(0, mode="dma", staging=tswap.HostBlockPool(8))
        narrow = tserve.ServeEngine(tparams, tcfg, slots=1, prompt_slots=4, max_new_cap=2,
                                    prefix_window=2, device="cpu")
        with pytest.raises(ValueError, match="table rows hold"):
            narrow.handoff_in(payload)

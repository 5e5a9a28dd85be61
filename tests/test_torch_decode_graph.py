"""The burn-in LM's paged decode step replayed as captured CUDA graphs
(`paged.DecodeGraphs` over `paged._decode_parts`, the engine's graph
path) against the port's own eager step (`paged.paged_decode_step_rows`),
and which engines take which path.

The card tests (marked ``cuda``; each skips where torch sees no CUDA
device) run at the ``burnin-lm-80g`` widths (vocab 32768, d_model 4096,
32 heads of 128, d_ff 16384, 8 layers, seq 1024) and hold the replay
BITWISE equal to the eager step: the same kernels run in the same order
on the same stream, and the dense step sums with no atomics.  128 rows at
positions across every block column, overrun rows (at and past the
reach), frozen rows (a table row of scratch) and rows that share their
first blocks (a prefix hit's aliased tables), over bf16 and int8 pools,
through K1 and through the gather: five chained steps compare every pool
block but scratch, and the logits of every row that reads real blocks (a
frozen or overrun row reads scratch, which the capture's warm-up and the
overrun rows' racing writes fill, and the engine drops its logits, so
such a row is held to nothing but running); the capture writes scratch alone and
counts no K1 launch; two replays in a row each read their own inputs;
greedy engines with the graphs (continuous and fused ticks, bf16 and
int8) serve an eager engine's tokens with K1 counted 8 a step, and so
does a two-replica `ServeFleet` on one card.  On a GPU host:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph.py -q

The CPU tests hold the eager path to its count and the one-device step
to the prefill's block loop (`decode._run_blocks`) bitwise.  This module
imports neither JAX nor the reference package."""

import threading

import pytest
import torch

from tpu_dra_torch.fleet import ServeFleet
from tpu_dra_torch.parallel import burnin, decode, paged, quant
from tpu_dra_torch.parallel.kernels import paged_attn
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.parallel.weights import cast_matrices
from tpu_dra_torch.utils import metrics

FULL = burnin.BurninConfig(vocab=32768, d_model=4096, n_heads=32, d_ff=16384, n_layers=8,
                           seq=1024)
W, COLS, B, STEPS = 128, 8, 128, 5  # the dense-chat engine's block, table width and rows
SMALL = burnin.BurninConfig(vocab=512, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=128)
ENGINE = dict(slots=4, prompt_slots=64, max_new_cap=32, prefix_window=16)
STREAM = [(1, 5), (15, 9), (16, 3), (17, 7), (64, 12), (40, 6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and replayed only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_params():
    """The served trees at full width, built once: bf16 layer matrices,
    and int8 pairs (quantized from the same f32 draw)."""
    trees = {}

    def get(int8: bool):
        if not trees:
            dev = torch.device("cuda")
            raw = burnin.init_params(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
            trees[True] = quant.quantize_params(raw)
            trees[False] = cast_matrices(raw)
            del raw
            torch.cuda.empty_cache()
        return trees[int8]

    return get


def _layout(dev):
    """Rows' tables and positions for `STEPS` chained steps: row b at
    position ``(37 b) % 1000``, its blocks distinct and allocated through
    the column its last step writes; rows 0-7 share the blocks of
    columns 0 and 1 (and write past them); rows 120-123 frozen (a table of
    scratch); rows 124-125 cross the reach (1023 and 1022) and row 126
    starts past it (1030).  Returns ``(table, pos, live, NB)``."""
    pos = [(37 * b) % 1000 for b in range(B)]
    for b in range(8):
        pos[b] = max(pos[b], 2 * W)
    pos[124], pos[125], pos[126] = 1023, 1022, 1030
    frozen = set(range(120, 124))
    table = [[0] * COLS for _ in range(B)]
    nxt = 1
    shared = [nxt, nxt + 1]
    nxt += 2
    for b in range(B):
        if b in frozen:
            continue
        last = min(pos[b] + STEPS - 1, COLS * W - 1) // W
        for c in range(last + 1):
            if b < 8 and c < 2:
                table[b][c] = shared[c]
            else:
                table[b][c] = nxt
                nxt += 1
    live = [b not in frozen for b in range(B)]
    return (torch.tensor(table, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(live, device=dev), nxt)


def _reads_real_blocks(table, pos):
    """The rows whose step reads no scratch: a table of blocks (not a
    frozen row's scratch) and a position inside the reach."""
    return (table[:, 0] != 0) & (pos < COLS * W)


def _pool(cfg, nb: int, dev, int8: bool, seed: int = 1):
    """A pool of random KV, one layer at a time (bf16, or quantized per
    token and head), so that every step reads real values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = paged.init_block_pool(cfg, nb, W, kv_int8=int8, device=dev)
    for leaf in ("k", "v"):
        for i in range(cfg.n_layers):
            a = torch.randn((nb, W, cfg.n_heads, cfg.d_head), generator=g, device=dev)
            if int8:
                qs = quant.quantize_tensor(a, (3,))
                pool[leaf]["q"][i].copy_(qs["q"])
                pool[leaf]["s"][i].copy_(qs["s"])
            else:
                pool[leaf][i].copy_(a.to(torch.bfloat16))
    return pool


def _leaves(pool):
    leaves = []
    paged._tree_map(leaves.append, pool)
    return leaves


def _assert_pools_equal(got, want):
    """Every block but scratch block 0, bitwise."""
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g[:, 1:], w[:, 1:])


def _graph_seam(cfg, params, pool, backend, dev):
    """A `PagedLM` with its decode step captured over static inputs of
    zeros (the engine's layout: tokens, positions, then the tables)."""
    seam = paged.PagedLM(cfg)
    state = torch.zeros(2 * B + B * COLS, dtype=torch.int32, device=dev)
    seam.capture_decode(params, pool, state[:B], state[2 * B:].view(B, COLS), state[B:2 * B],
                        backend)
    return seam


@pytest.mark.cuda
class TestReplayIsTheEagerStep:
    @pytest.mark.parametrize("backend", ["cuda", "gather"])
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_chained_steps_bitwise(self, cuda, full_params, int8, backend):
        params = full_params(int8)
        table, pos, live, nb = _layout(cuda)
        want_pool = _pool(FULL, nb, cuda, int8)
        got_pool = paged._tree_map(torch.clone, want_pool)
        seam = _graph_seam(FULL, params, got_pool, backend, cuda)
        tok = torch.arange(B, dtype=torch.int32, device=cuda) * 251 % FULL.vocab
        before = paged_attn.paged_attention.launches
        for step in range(STEPS):
            want, _ = paged.paged_decode_step_rows(params, tok, want_pool, table, pos, FULL,
                                                   backend=backend)
            got, _ = seam.decode(params, tok, got_pool, table, pos, backend)
            assert seam.decode_path == "graph"
            real = _reads_real_blocks(table, pos)
            assert 100 < int(real.sum()) < B
            assert torch.equal(got[real], want[real]), step
            tok = torch.where(live, want.argmax(-1).int(), tok)
            pos = torch.where(live, pos + 1, pos)
        torch.cuda.synchronize()
        _assert_pools_equal(got_pool, want_pool)
        launched = paged_attn.paged_attention.launches - before
        assert launched == (2 * STEPS * FULL.n_layers if backend == "cuda" else 0)

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_capture_writes_scratch_alone_and_counts_no_launch(self, cuda, full_params, int8):
        params = full_params(int8)
        _, _, _, nb = _layout(cuda)
        pool = _pool(FULL, nb, cuda, int8)
        before_pool = paged._tree_map(torch.clone, pool)
        before = paged_attn.paged_attention.launches
        _graph_seam(FULL, params, pool, "cuda", cuda)
        torch.cuda.synchronize()
        assert paged_attn.paged_attention.launches == before
        _assert_pools_equal(pool, before_pool)

    def test_two_replays_in_a_row_read_their_own_inputs(self, cuda, full_params):
        """Two steps back to back over other tokens, positions and tables,
        no sync between them: each replay equal to its own eager step."""
        params = full_params(False)
        table, pos, _, nb = _layout(cuda)
        want_pool = _pool(FULL, nb, cuda, False)
        got_pool = paged._tree_map(torch.clone, want_pool)
        seam = _graph_seam(FULL, params, got_pool, "cuda", cuda)
        tok_a = torch.arange(B, dtype=torch.int32, device=cuda) * 7 % FULL.vocab
        tok_b = torch.arange(B, dtype=torch.int32, device=cuda) * 13 % FULL.vocab
        table_b = table.flip(0).contiguous()
        pos_b = (pos.flip(0) + 1).contiguous()
        got_a = seam.decode(params, tok_a, got_pool, table, pos, "cuda")[0].clone()
        got_b = seam.decode(params, tok_b, got_pool, table_b, pos_b, "cuda")[0]
        want_a, _ = paged.paged_decode_step_rows(params, tok_a, want_pool, table, pos, FULL,
                                                 backend="cuda")
        want_b, _ = paged.paged_decode_step_rows(params, tok_b, want_pool, table_b, pos_b, FULL,
                                                 backend="cuda")
        assert not torch.equal(want_a, want_b)
        real_a, real_b = _reads_real_blocks(table, pos), _reads_real_blocks(table_b, pos_b)
        assert torch.equal(got_a[real_a], want_a[real_a])
        assert torch.equal(got_b[real_b], want_b[real_b])
        _assert_pools_equal(got_pool, want_pool)


def _stream(vocab: int, n: int = 16):
    """``n`` distinct prompts of 1 to 768 tokens and budgets of 3 to 60."""
    lengths = [1, 127, 128, 129, 300, 768, 64, 512, 5, 700, 250, 384, 33, 640, 200, 96]
    return [([(11 * i + 3 * j) % vocab for j in range(lengths[i % 16])], 3 + (17 * i) % 58)
            for i in range(n)]


def _drain(eng, stream):
    ids = [eng.submit(p, b) for p, b in stream]
    eng.run()
    return [eng.request(i).tokens for i in ids]


def _steps(eng):
    s = eng.prefix_stats
    return s["decode_steps_graph"], s["decode_steps_eager"]


@pytest.mark.cuda
class TestEngineOnTheCard:
    @pytest.mark.parametrize("scheduling", ["continuous", "tick"])
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_graph_engine_tokens_equal_the_eager_engines(self, cuda, full_params, int8,
                                                         scheduling):
        """K1 counted 8 a step on the graph engine, from before its build
        (the capture counts none); a fused tick replays once a step."""
        spec = dict(slots=16, prompt_slots=768, max_new_cap=64, prefix_window=W, kv_int8=int8,
                    scheduling=scheduling, steps_per_tick=4)
        params = full_params(int8)
        stream = _stream(FULL.vocab)
        before = paged_attn.paged_attention.launches
        eng = ServeEngine(params, FULL, **spec)
        got = _drain(eng, stream)
        torch.cuda.synchronize()
        launched = paged_attn.paged_attention.launches - before
        assert launched == eng.device_steps * FULL.n_layers
        assert _steps(eng) == (eng.device_steps, 0)
        eng.close()
        ref = ServeEngine(params, FULL, **spec)
        ref._model.drop_decode_graphs()  # the eager path, as the oracle
        assert _drain(ref, stream) == got
        assert _steps(ref) == (0, ref.device_steps)
        ref.close()

    def test_two_replica_fleet_on_one_card(self, cuda, full_params):
        """A threaded fleet of two graph replicas serves the tokens of the
        same fleet with its replicas put on the eager path, every replica
        step replayed and K1 counted 8 a step."""
        params = full_params(False)
        spec = dict(slots=8, prompt_slots=768, max_new_cap=64, prefix_window=W,
                    prefix_cache_slots=4)
        prefix = [(5 * j) % FULL.vocab for j in range(300)]
        stream = [(prefix[:256 + 40 * (i % 3)] + p[:100], b) for i, (p, b) in
                  enumerate(_stream(FULL.vocab))]
        tokens = {}
        for graphs in (True, False):
            engines = [ServeEngine(params, FULL, name=f"dg-{graphs}-{r}", **spec)
                       for r in range(2)]
            if not graphs:
                for e in engines:
                    e._model.drop_decode_graphs()
            fleet = ServeFleet(engines, seed=3, name=f"fleet-dg-{graphs}",
                               max_queue_per_replica=64)
            before = paged_attn.paged_attention.launches
            fids = [fleet.submit(p, b) for p, b in stream]
            fleet.run()
            torch.cuda.synchronize()
            steps = sum(e.device_steps for e in engines)
            assert paged_attn.paged_attention.launches - before == steps * FULL.n_layers
            for e in engines:
                assert _steps(e) == ((e.device_steps, 0) if graphs else (0, e.device_steps))
            tokens[graphs] = [fleet.result(f).tokens for f in fids]
            fleet.close()
        assert tokens[True] == tokens[False]

    def test_closed_engine_drops_its_decode_graphs(self, cuda):
        params = cast_matrices(burnin.init_params(SMALL, device=cuda))
        eng = ServeEngine(params, SMALL, **ENGINE)
        assert eng._model._decode_graphs is not None
        eng.close()
        assert eng._model._decode_graphs is None


# -- the CPU: the eager path and its count ----------------------------------


def _cpu_params(int8: bool):
    params = burnin.init_params(SMALL, torch.Generator().manual_seed(0), device="cpu")
    return quant.quantize_params(params) if int8 else params


def _small_stream():
    return [([(7 * i + j) % SMALL.vocab for j in range(n)], b)
            for i, (n, b) in enumerate(STREAM)]


class TestEagerPath:
    @pytest.mark.parametrize("scheduling", ["continuous", "tick"])
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_cpu_engine_counts_every_step_eager(self, int8, scheduling):
        before = {p: metrics.SERVE_DECODE_STEPS.value(path=p) for p in ("graph", "eager")}
        eng = ServeEngine(_cpu_params(int8), SMALL, device="cpu", kv_int8=int8,
                          scheduling=scheduling, steps_per_tick=3, **ENGINE)
        assert eng._model._decode_graphs is None
        _drain(eng, _small_stream())
        assert eng.device_steps > 0 and _steps(eng) == (0, eng.device_steps)
        moved = {p: metrics.SERVE_DECODE_STEPS.value(path=p) - before[p]
                 for p in ("graph", "eager")}
        assert moved == {"graph": 0, "eager": eng.device_steps}

    def test_rows_engine_counts_its_steps_eager(self):
        eng = ServeEngine(_cpu_params(False), SMALL, device="cpu", kv_layout="rows", **ENGINE)
        _drain(eng, _small_stream())
        assert eng.device_steps > 0 and _steps(eng) == (0, eng.device_steps)

    def test_engine_counts_the_path_the_seam_reports(self):
        eng = ServeEngine(_cpu_params(False), SMALL, device="cpu", **ENGINE)
        model, reported = eng._model, []
        real = model.decode

        def decode(*args):
            out = real(*args)
            model.decode_path = "graph" if len(reported) % 3 else "eager"
            reported.append(model.decode_path)
            return out

        model.decode = decode
        _drain(eng, _small_stream())
        assert _steps(eng) == (reported.count("graph"), reported.count("eager"))
        assert len(reported) == eng.device_steps and "graph" in reported

    def test_keys_and_family_start_at_zero_on_both_paths(self):
        eng = ServeEngine(_cpu_params(False), SMALL, device="cpu", **ENGINE)
        assert _steps(eng) == (0, 0)
        text = metrics.SERVE_DECODE_STEPS.collect()
        assert "# TYPE tpu_dra_serve_decode_steps_total counter" in text
        for path in ("graph", "eager"):
            assert f'tpu_dra_serve_decode_steps_total{{path="{path}"}}' in text
        assert metrics.SERVE_DECODE_STEPS in metrics.REGISTRY._metrics


class TestStepIsTheBlockLoop:
    @pytest.mark.parametrize("backend", ["cuda", "gather"])
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_parts_equal_the_prefill_block_loop_bitwise(self, int8, backend):
        """The step's parts (per-half dequantization included) against
        `decode._run_blocks` over the same kv_io, the block loop the
        prefill windows run, on every row kind: live, frozen (scratch
        table), at and past the reach.  ``"cuda"`` on CPU tensors is K1's
        plain version."""
        torch.manual_seed(5)
        params = _cpu_params(int8)
        nb, cols, rows = 14, 4, 6
        pool = paged.init_block_pool(SMALL, nb, 16, kv_int8=int8, device="cpu")
        for leaf in _leaves(pool):
            leaf.copy_(torch.randn(leaf.shape) if leaf.dtype != torch.int8
                       else torch.randint(-127, 128, leaf.shape, dtype=torch.int8))
        if int8:
            for name in ("k", "v"):
                pool[name]["s"].abs_().mul_(0.02)
        table = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0], [7, 8, 9, 10],
                              [11, 12, 13, 0], [1, 2, 0, 0]], dtype=torch.int32)[:rows]
        pos = torch.tensor([40, 20, 9, 63, 70, 5], dtype=torch.int32)
        tok = torch.tensor([3, 99, 7, 511, 0, 42], dtype=torch.int32)
        want_pool = paged._tree_map(torch.clone, pool)
        got, _ = paged.paged_decode_step_rows(params, tok, pool, table, pos, SMALL,
                                              backend=backend)
        tab, p = paged._clamp_to_reach(table, pos, 16, SMALL.seq)
        x = decode._embed_lookup(params["embed"], tok)[:, None, :] + params["pos"][p][:, None]
        mask = (torch.arange(cols * 16)[None, :] <= p[:, None])[:, None, None, :]
        kv = paged._PagedKernelKV(tab, 16, p) if backend == "cuda" else paged._PagedKV(tab, 16)
        want, _ = decode._run_blocks(params, x, want_pool, p, mask, SMALL, kv_io=kv)
        assert torch.equal(got, want[:, 0])
        for g, w in zip(_leaves(pool), _leaves(want_pool)):
            assert torch.equal(g, w)


class TestK1Counter:
    def test_note_replays_adds_launches(self):
        before = paged_attn.paged_attention.launches
        paged_attn.note_replays(8)
        assert paged_attn.paged_attention.launches == before + 8

    def test_uncounted_leaves_out_this_threads_launches_alone(self):
        before = paged_attn.paged_attention.launches
        other = threading.Thread(target=paged_attn._count_launch)
        with paged_attn.uncounted():
            paged_attn._count_launch()
            other.start()
            other.join(timeout=10)
        assert not other.is_alive()
        assert paged_attn.paged_attention.launches == before + 1
        paged_attn._count_launch()
        assert paged_attn.paged_attention.launches == before + 2

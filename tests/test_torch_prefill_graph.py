"""The paged admission prefill replayed as captured CUDA graphs
(`paged.PrefillGraphs`, the engine's graph path) against the port's own
eager prefill (`paged.make_paged_prefill`), and which engines take which
path.

The card tests (marked ``cuda``; each skips where torch sees no CUDA
device) hold the replay BITWISE equal to the eager windows: the same
kernels run in the same order on the same stream, so nothing may move.
They cover bf16 and int8 pools, a first window of 0 and 2 (a prefix
hit's aliased windows), prompt lengths 1, W - 1, W, W + 1 and
``prompt_slots``, two replays in a row over other prompts and tables,
the capture's writes (scratch block 0 alone), and engines: a graph
engine's greedy tokens against an engine put on the eager path, with the
prefix cache on, and the alias tiers of a `DisaggServer`, whose prefill
tier captures again on the shared pool when the server is built (the
decode tier captures nothing).  On a GPU host:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prefill_graph.py -q

The CPU tests hold the eager path to its count: a CPU engine captures
nothing, and ``prefix_stats`` and ``tpu_dra_serve_prefill_windows_total``
count every window it runs.  This module imports neither JAX nor the
reference package."""

import pytest
import torch

from tpu_dra_torch.parallel import burnin, paged, quant
from tpu_dra_torch.parallel.disagg import DisaggServer
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.parallel.weights import cast_matrices
from tpu_dra_torch.utils import metrics

CFG = burnin.BurninConfig(vocab=512, d_model=128, n_heads=4, d_ff=256, n_layers=2, seq=128)
W, PROMPT_SLOTS, MAX_NEW = 16, 64, 32
NWIN = PROMPT_SLOTS // W
TABLE_COLS = (PROMPT_SLOTS + MAX_NEW) // W  # 6: the engine's table width
NB = 2 * TABLE_COLS + 1  # scratch and two requests' blocks
LENGTHS = [1, W - 1, W, W + 1, PROMPT_SLOTS]
ENGINE = dict(slots=2, prompt_slots=PROMPT_SLOTS, max_new_cap=MAX_NEW, prefix_window=W)
# (prompt length, budget): every length of LENGTHS, and one mid-window.
STREAM = [(n, b) for n, b in zip(LENGTHS + [40], (5, 9, 3, 7, 12, 6))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and replayed only there")
    return torch.device("cuda")


def _params(dev, int8: bool, cfg=CFG):
    """The engine's serving tree: bf16 layer matrices, or int8 pairs."""
    params = burnin.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return quant.quantize_params(params) if int8 else cast_matrices(params)


def _pool(dev, int8: bool, cfg=CFG, seed=1):
    """A pool of random KV (bf16, or quantized per token and head), so
    that the windows before a first window of 2 read real values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.n_layers, NB, W, cfg.n_heads, cfg.d_head)
    leaves = {n: torch.randn(shape, generator=g, device=dev) for n in ("k", "v")}
    if int8:
        return {n: quant.quantize_tensor(a, (4,)) for n, a in leaves.items()}
    return {n: a.to(torch.bfloat16) for n, a in leaves.items()}


def _clone(pool):
    return paged._tree_map(torch.clone, pool)


def _leaves(pool):
    leaves = []
    paged._tree_map(leaves.append, pool)
    return leaves


def _request(dev, length: int, table_row, seed: int):
    """A prompt of ``length`` tokens: the eager prefill's ``(prompt (1,
    P), lens (1,), table (1, cols))`` and the engine's staging row
    (prompt, table row, length) that the graphs' ``staged`` takes."""
    g = torch.Generator().manual_seed(seed)
    prompt = torch.zeros((1, PROMPT_SLOTS), dtype=torch.int32)
    prompt[0, :length] = torch.randint(0, CFG.vocab, (length,), generator=g)
    table = torch.tensor([table_row], dtype=torch.int32)
    lens = torch.tensor([length], dtype=torch.int32)
    row = torch.cat([prompt[0], table[0], lens])
    return prompt.to(dev), lens.to(dev), table.to(dev), row.to(dev)


def _assert_pools_equal(got, want):
    """Every block but scratch block 0, bitwise (the windows past a
    prompt's end write the row's own decode blocks, alike on both)."""
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g[:, 1:], w[:, 1:])


def _eager(params, pool, prompt, lens, table, first_window, cfg=CFG):
    last, _ = paged.make_paged_prefill(cfg, PROMPT_SLOTS, W)(
        params, prompt, lens, pool, table, first_window)
    return last


@pytest.mark.cuda
class TestReplayIsTheEagerPrefill:
    @pytest.mark.parametrize("length", LENGTHS)
    @pytest.mark.parametrize("first_window", [0, 2])
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_last_and_blocks_bitwise(self, cuda, int8, first_window, length):
        params, pool = _params(cuda, int8), _pool(cuda, int8)
        want_pool, got_pool = _clone(pool), _clone(pool)
        graphs = paged.PrefillGraphs(CFG, PROMPT_SLOTS, W, TABLE_COLS, params, got_pool)
        prompt, lens, table, row = _request(cuda, length, [3, 1, 5, 2, 6, 4], seed=length)
        graphs.staged.copy_(row)
        got = graphs(first_window)
        want = _eager(params, want_pool, prompt, lens, table, first_window)
        assert torch.equal(got, want)
        _assert_pools_equal(got_pool, want_pool)

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_two_replays_in_a_row_read_their_own_inputs(self, cuda, int8):
        """Two admissions back to back, no sync between them: other
        prompts, lengths and tables, each replay equal to its own eager
        run, the first's logits untouched by the second replay."""
        params, pool = _params(cuda, int8), _pool(cuda, int8)
        want_pool, got_pool = _clone(pool), _clone(pool)
        graphs = paged.PrefillGraphs(CFG, PROMPT_SLOTS, W, TABLE_COLS, params, got_pool)
        a = _request(cuda, W + 1, [1, 2, 3, 4, 5, 6], seed=7)
        b = _request(cuda, PROMPT_SLOTS - 3, [7, 8, 9, 10, 11, 12], seed=8)
        graphs.staged.copy_(a[3], non_blocking=True)
        got_a = graphs(0)
        graphs.staged.copy_(b[3], non_blocking=True)
        got_b = graphs(0)
        want_a = _eager(params, want_pool, *a[:3], 0)
        want_b = _eager(params, want_pool, *b[:3], 0)
        assert not torch.equal(want_a, want_b)
        assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
        _assert_pools_equal(got_pool, want_pool)

    def test_rope_model_replays_bitwise(self, cuda):
        cfg = burnin.BurninConfig(vocab=512, d_model=128, n_heads=4, d_ff=256, n_layers=2,
                                  seq=128, rope=True)
        params, pool = _params(cuda, False, cfg), _pool(cuda, False, cfg)
        want_pool, got_pool = _clone(pool), _clone(pool)
        graphs = paged.PrefillGraphs(cfg, PROMPT_SLOTS, W, TABLE_COLS, params, got_pool)
        prompt, lens, table, row = _request(cuda, 2 * W + 5, [2, 4, 6, 1, 3, 5], seed=9)
        graphs.staged.copy_(row)
        got = graphs(1)
        assert torch.equal(got, _eager(params, want_pool, prompt, lens, table, 1, cfg))
        _assert_pools_equal(got_pool, want_pool)

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_capture_writes_scratch_alone(self, cuda, int8):
        """The warm-up and the capture run on a table of scratch: every
        other block keeps its bits."""
        params, pool = _params(cuda, int8), _pool(cuda, int8)
        before = _clone(pool)
        graphs = paged.PrefillGraphs(CFG, PROMPT_SLOTS, W, TABLE_COLS, params, pool)
        torch.cuda.synchronize()
        _assert_pools_equal(pool, before)
        with pytest.raises(ValueError, match="first_window"):
            graphs(NWIN)


def _drain(eng, stream=STREAM, prefix=()):
    """Submit ``stream`` (``prefix`` then distinct tails), run the engine
    dry; returns the requests in submission order."""
    ids = [eng.submit(list(prefix) + [(7 * i + j) % CFG.vocab for j in range(n - len(prefix))],
                      budget)
           for i, (n, budget) in enumerate(stream)]
    eng.run()
    return [eng.request(i) for i in ids]


def _tokens(reqs):
    return [r.tokens for r in reqs]


def _windows(eng):
    s = eng.prefix_stats
    return s["prefill_windows_graph"], s["prefill_windows_eager"]


@pytest.mark.cuda
class TestEngineOnTheCard:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_graph_engine_tokens_equal_the_eager_engines(self, cuda, int8):
        params = _params(cuda, int8)
        eng = ServeEngine(params, CFG, kv_int8=int8, **ENGINE)
        ref = ServeEngine(params, CFG, kv_int8=int8, **ENGINE)
        ref._prefill_graphs = None  # the eager path, as the oracle
        assert isinstance(eng._prefill_graphs, paged.PrefillGraphs)
        assert _tokens(_drain(eng)) == _tokens(_drain(ref))
        assert _windows(eng) == (len(STREAM) * NWIN, 0)
        assert _windows(ref) == (0, len(STREAM) * NWIN)

    def test_prefix_hits_replay_from_their_first_window(self, cuda):
        params = _params(cuda, False)
        spec = dict(ENGINE, prefix_cache_slots=4)
        eng, ref = ServeEngine(params, CFG, **spec), ServeEngine(params, CFG, **spec)
        ref._prefill_graphs = None
        shared = [(5 * j) % CFG.vocab for j in range(2 * W + 3)]
        stream = [(2 * W + 9, 4), (3 * W + 1, 6), (PROMPT_SLOTS, 3), (2 * W + 4, 5)]
        reqs = _drain(eng, stream, shared)
        assert _tokens(reqs) == _tokens(_drain(ref, stream, shared))
        assert eng.prefix_stats["hits"] > 0
        assert eng.prefix_stats["hits"] == ref.prefix_stats["hits"]
        computed = sum(NWIN - r.prefix_reused // W for r in reqs)
        assert computed < len(stream) * NWIN
        assert _windows(eng) == (computed, 0) and _windows(ref) == (0, computed)

    def test_alias_tiers_capture_again_on_the_shared_pool(self, cuda):
        """The alias server rebinds the prefill tier's pool to the decode
        tier's after both are built, and captures the prefill tier's
        windows again there: its replays write the blocks the decode tier
        reads, so the server serves the mono eager engine's tokens.  The
        decode tier, which never prefills, captures nothing."""
        params = _params(cuda, False)
        tier = dict(slots=2, prompt_slots=PROMPT_SLOTS, max_new_cap=MAX_NEW, prefix_window=W)
        srv = DisaggServer(params, CFG, prefill=dict(tier), decode=dict(tier), handoff="alias")
        pre = srv._prefill
        assert pre._pool is srv._decode._pool
        assert isinstance(pre._prefill_graphs, paged.PrefillGraphs)
        assert srv._decode._prefill_graphs is None
        dids = [srv.submit([(3 * i + j) % CFG.vocab for j in range(n)], b)
                for i, (n, b) in enumerate(STREAM)]
        srv.run()
        assert _windows(pre) == (len(STREAM) * NWIN, 0)
        assert _windows(srv._decode) == (0, 0)
        ref = ServeEngine(params, CFG, **ENGINE)
        ref._prefill_graphs = None
        rids = [ref.submit([(3 * i + j) % CFG.vocab for j in range(n)], b)
                for i, (n, b) in enumerate(STREAM)]
        ref.run()
        assert [srv.result(d).tokens for d in dids] == [ref.request(r).tokens for r in rids]

    def test_closed_engine_drops_its_graphs(self, cuda):
        eng = ServeEngine(_params(cuda, False), CFG, **ENGINE)
        assert eng._prefill_graphs is not None
        eng.close()
        assert eng._prefill_graphs is None


def _cpu_params(int8: bool):
    params = burnin.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    return quant.quantize_params(params) if int8 else params


class TestEagerPath:
    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_cpu_engine_runs_every_window_eagerly(self, int8):
        before = {p: metrics.SERVE_PREFILL_WINDOWS.value(path=p) for p in ("graph", "eager")}
        eng = ServeEngine(_cpu_params(int8), CFG, device="cpu", kv_int8=int8, **ENGINE)
        assert eng._prefill_graphs is None
        assert [len(r.tokens) for r in _drain(eng)] == [b for _, b in STREAM]
        assert _windows(eng) == (0, len(STREAM) * NWIN)
        moved = {p: metrics.SERVE_PREFILL_WINDOWS.value(path=p) - before[p]
                 for p in ("graph", "eager")}
        assert moved == {"graph": 0, "eager": len(STREAM) * NWIN}

    def test_prefix_hits_count_the_windows_they_compute(self):
        eng = ServeEngine(_cpu_params(False), CFG, device="cpu", prefix_cache_slots=4,
                          **ENGINE)
        shared = [(5 * j) % CFG.vocab for j in range(2 * W + 3)]
        stream = [(2 * W + 9, 4), (3 * W + 1, 6), (2 * W + 4, 5)]
        reused = [r.prefix_reused for r in _drain(eng, stream, shared)]
        assert reused[0] == 0 and all(r == 2 * W for r in reused[1:])
        assert _windows(eng) == (0, len(stream) * NWIN - 2 * (len(stream) - 1))

    def test_rows_engine_counts_no_paged_windows(self):
        eng = ServeEngine(_cpu_params(False), CFG, device="cpu", kv_layout="rows", **ENGINE)
        _drain(eng)
        assert _windows(eng) == (0, 0)
        assert eng._prefill_graphs is None

    def test_counter_family_carries_both_paths(self):
        text = metrics.SERVE_PREFILL_WINDOWS.collect()
        assert "# TYPE tpu_dra_serve_prefill_windows_total counter" in text
        for path in ("graph", "eager"):
            assert f'tpu_dra_serve_prefill_windows_total{{path="{path}"}}' in text
        assert metrics.SERVE_PREFILL_WINDOWS in metrics.REGISTRY._metrics

"""The port's serving on a mesh (tpu_dra_torch/parallel/decode.py,
paged.py, prefixcache.py, serve.py, speculative.py with ``mesh=``,
quant.quant_param_specs, weights.shard_params, models.serve_family over
the family's mesh) against the reference's (tpu_dra/parallel/decode.py,
paged.py, quant.py, models) on its 8 virtual CPU devices.

The port's side runs in 8 gloo ranks spawned once for this module
(`test_torch_sharded.Ranks`, threads capped at 1, each wait bounded) on
the mesh data 2, fsdp 2, model 2 (and `moe_mesh` data 2, model 2, expert
2), each rank serving its shards of the reference's own weights
(`weights.shard_params` of the whole tree, quantized by the reference
first for int8), and returning what it computed; the parent puts the
rows back together while it runs the reference's sharded programs.

Tolerances:

- specs: equal;
- logits: within ``4e-2`` of the reference's mesh logits (its own mesh
  tolerance, tests/test_decode.py: a couple of bf16 ulps at these logit
  magnitudes, the sharded reductions reassociated);
- greedy tokens: equal up to a near-tie, a first divergence where the
  reference's one-device logits along the generation's own path have a
  top-2 margin within ``NEAR_TIE`` (twice the logit tolerance: each side
  may stand 4e-2 off); sampled tokens: the same on the perturbed logits
  ``logits / T + g``, the margin within ``NEAR_TIE / T``;
- on a one-rank mesh: bitwise the port's one-device results;
- the paged pool: bitwise equal on every rank of one ``model`` index
  after every tick (its replicas over data x fsdp)."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

import test_torch_sharded as tsh
from tpu_dra import models as jmodels
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import decode as jd
from tpu_dra.parallel import paged as jp
from tpu_dra.parallel import quant as jq
from tpu_dra.parallel.mesh import logical_mesh as jlogical
from tpu_dra_torch import models as tmodels
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import paged as tp
from tpu_dra_torch.parallel import prng, spmd, weights
from tpu_dra_torch.parallel import quant as tq
from tpu_dra_torch.parallel import speculative as tspec
from tpu_dra_torch.parallel import validate as tvalidate
from tpu_dra_torch.parallel.mesh import logical_mesh as tlogical
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(1)

WORLD = 8
MESH = dict(data=2, fsdp=2, model=2)
SIZES = dict(MESH)
LOGIT_TOL = 4e-2
NEAR_TIE = 2 * LOGIT_TOL
# The reference's decode TINY and serve CFG shapes (tests/test_decode.py,
# tests/test_serve.py).
TINY = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=16, batch=4)
SERVE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4)
PLEN = 6
# The __graft_entry__ serve stanzas' config (its lines 107 and 148).
STANZA = dict(n_layers=2, seq=64, d_model=64, d_ff=128)
SHARED = [5, 9, 2, 7, 11, 3]  # test_paged's shared system prompt
ENGINE = dict(slots=4, prompt_slots=8, max_new_cap=3)
SAMPLED = dict(temperature=0.8, with_logprobs=True)
SEEDS = [101, 202, 303, 404, 505, 606]


def _prefix_stream():
    return [(SHARED[:4] + [i + 1], 3) for i in range(6)]


def _mixed_stream(vocab, n=6, seed=4):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(1, vocab, int(rng.randint(2, 9)))],
             int(rng.randint(2, 4))) for _ in range(n)]


# Preemption: 2 priority-0 requests fill a 9-block pool; a tick later a
# priority-5 one needs blocks, and one of the two is swapped out (both
# are candidates, so the victim policy picks).  (prompt, budget,
# priority, the tick it arrives before)
PREEMPT = dict(slots=3, prompt_slots=8, max_new_cap=8, kv_blocks=9, prefix_window=4)
PREEMPT_REQS = [([3, 4, 5, 6, 7, 8, 9, 10], 8, 0, 0), ([11, 12, 13, 14, 15, 16, 17, 18], 8, 0, 0),
                ([21, 22, 23, 24, 25, 26, 27], 6, 5, 1)]


# --- what each rank runs ------------------------------------------------


def _mesh():
    return tlogical(**MESH)


def _shards(tree, cfg, mesh):
    return weights.shard_params(weights.params_from_numpy(tree, device="cpu"), cfg, mesh)


def _rank_logits(rank, args):
    """decode_forward's prefill and step logits, the rank's rows, bf16 and
    the int8 stack."""
    fields, trees, prompt, nxt = args
    mesh = _mesh()
    cfg = tb.BurninConfig(**fields)
    out = {}
    for name, tree in trees.items():
        int8 = name == "int8"
        params = _shards(tree, cfg, mesh)
        cache = td.init_cache(cfg, prompt.shape[0], int8, mesh=mesh)
        pre, cache = td.decode_forward(params, torch.tensor(prompt), cache, 0, cfg, mesh)
        step, _ = td.decode_forward(params, torch.tensor(nxt)[:, None], cache, PLEN, cfg, mesh)
        out[name] = (pre.numpy(), step.numpy(), tuple(cache["k"]["q"].shape if int8
                                                      else cache["k"].shape))
    return out


def _rank_stanzas(rank, args):
    """The three __graft_entry__ serve stanzas: padded bf16, padded int8
    (weights and KV), rope make_generate."""
    sfields, strees, rfields, rtree = args
    mesh = _mesh()
    scfg, rcfg = tb.BurninConfig(**sfields), tb.BurninConfig(**rfields)
    sp = torch.ones((scfg.batch, 8), dtype=torch.int32)
    lens = torch.arange(scfg.batch, dtype=torch.int32) % 8 + 1
    out = {}
    for name, tree in strees.items():
        gen = td.make_generate_padded(scfg, mesh, prompt_slots=8, steps=4, with_health=True,
                                      kv_int8=name == "int8")
        toks, healthy = gen(_shards(tree, scfg, mesh), sp, lens)
        out[name] = (toks.numpy(), bool(healthy))
    gen = td.make_generate(rcfg, mesh, prompt_len=8, steps=4, with_health=True)
    toks, healthy = gen(_shards(rtree, rcfg, mesh), torch.ones((rcfg.batch, 8), dtype=torch.int32))
    out["rope"] = (toks.numpy(), bool(healthy))
    return out


def _pool_digest(pool):
    h = hashlib.sha256()
    for t in td._kv_tensors(pool):
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _drive(eng, reqs, digests=None, seeds=None):
    """Submit ``reqs`` ((prompt, budget[, priority, arrival tick])) and
    tick to the end, the pool's digest after every tick; the requests'
    tokens and logprobs in submit order."""
    ids = [None] * len(reqs)
    for tick in range(200):
        for i, r in enumerate(reqs):
            if (r[3] if len(r) > 3 else 0) == tick:
                ids[i] = eng.submit(r[0], r[1], seed=None if seeds is None else seeds[i],
                                    priority=r[2] if len(r) > 2 else 0)
        if None not in ids and not eng.pending:
            break
        eng.tick()
        if digests is not None:
            digests.append(_pool_digest(eng._pool))
    assert not eng.pending
    return [(list(eng.request(i).tokens), list(eng.request(i).logprobs)) for i in ids]


def _engines(params, cfg, mesh, skew_clock=False):
    """Every engine case: name -> (tokens and logprobs by request, the
    pool's digests by tick or None, prefix hits, preemptions, victims).
    ``skew_clock``: the preemption case runs with a monotonic clock that
    stamps the second row's blocks as born before the first's, then
    reads far ahead: a victim pick by block age in seconds would take the
    second row here and the first under the real clock."""
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    out = {}
    cases = {
        "paged prefix": (dict(ENGINE, prefix_cache_slots=4), _prefix_stream(), None),
        "rows prefix": (dict(ENGINE, prefix_cache_slots=4, kv_layout="rows"),
                        _prefix_stream(), None),
        "paged sampled": (dict(ENGINE, **SAMPLED), _mixed_stream(cfg.vocab), SEEDS),
        "rows sampled": (dict(ENGINE, kv_layout="rows", **SAMPLED), _mixed_stream(cfg.vocab),
                         SEEDS),
        # 3 slots: a batch that does not divide data x fsdp (replicated),
        # waves of 3 and 1.
        "paged 3 slots": (dict(ENGINE, slots=3), _mixed_stream(cfg.vocab, 4, seed=5), None),
        "rows chunked": (dict(ENGINE, kv_layout="rows", prefill_chunk=4),
                         _mixed_stream(cfg.vocab, 5, seed=6), None),
        "paged int8": (dict(ENGINE, kv_int8=True), _mixed_stream(cfg.vocab, 4, seed=7), None),
        "preemption": (PREEMPT, PREEMPT_REQS, None),
    }
    for name, (spec, reqs, seeds) in cases.items():
        p = params["int8"] if name == "paged int8" else params["bf16"]
        eng = ServeEngine(p, cfg, **spec, **kw)
        victims = []
        real = eng._swap_out

        def swap_out(row, by, _real=real, _victims=victims):
            _victims.append(row)
            return _real(row, by)

        eng._swap_out = swap_out
        digests = [] if eng.kv_layout == "paged" else None
        real_clock = tp.time.monotonic
        if skew_clock and name == "preemption":
            stamps = iter([10.0, 5.0])
            tp.time.monotonic = lambda: next(stamps, 1e3)
        try:
            got = _drive(eng, reqs, digests, seeds)
        finally:
            tp.time.monotonic = real_clock
        out[name] = (got, digests, eng.prefix_stats.get("hits", 0),
                     eng.kv_block_stats.get("preemptions_total", 0), victims)
        eng.close()
    return out


def _rank_engines(rank, args):
    fields, trees = args
    mesh = _mesh()
    cfg = tb.BurninConfig(**fields)
    params = {name: _shards(tree, cfg, mesh) for name, tree in trees.items()}
    # Odd ranks' clocks skewed against the even ranks'.
    return _engines(params, cfg, mesh, skew_clock=rank % 2 == 1)


def _rank_one_rank(rank, args):
    """On a one-rank mesh (each rank its own), rank 0 holds every mesh
    path to the one-device path: whether each is bitwise equal."""
    fields, trees, prompt = args
    mesh = tlogical([dist.get_rank()], data=1, fsdp=1, model=1)
    if rank:
        return None
    cfg = tb.BurninConfig(**fields)
    one = {n: weights.params_from_numpy(t, device="cpu") for n, t in trees.items()}
    meshed = {n: weights.shard_params(p, cfg, mesh) for n, p in one.items()}
    prompt = torch.tensor(prompt)
    lens = torch.tensor([8, 3, 5, 1], dtype=torch.int32)
    out = {}
    key = prng.key(7)
    for name in one:
        int8 = name == "int8"
        for label, kw, args_ in (
                ("generate", dict(prompt_len=prompt.shape[1], steps=5, with_logprobs=True,
                                  with_health=True), (prompt,)),
                ("sampled", dict(prompt_len=prompt.shape[1], steps=5, temperature=0.8,
                                 top_k=20, with_logprobs=True), (prompt, key)),
                ("padded", dict(prompt_slots=8, steps=4, with_health=True),
                 (torch.ones((4, 8), dtype=torch.int32) * 3, lens))):
            make = td.make_generate_padded if label == "padded" else td.make_generate
            a = make(cfg, kv_int8=int8, **kw)(one[name], *args_)
            b = make(cfg, mesh, kv_int8=int8, **kw)(meshed[name], *args_)
            a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
            out[f"{label} {name}"] = all(torch.equal(x, y) for x, y in zip(a, b))
        cache_a = td.init_cache(cfg, 4, int8, device="cpu")
        cache_b = td.init_cache(cfg, 4, int8, mesh=mesh)
        la, _ = td.decode_forward(one[name], prompt, cache_a, 0, cfg)
        lb, _ = td.decode_forward(meshed[name], prompt, cache_b, 0, cfg, mesh)
        out[f"logits {name}"] = torch.equal(la, lb) and all(
            torch.equal(x, y) for x, y in zip(td._kv_tensors(cache_a), td._kv_tensors(cache_b)))
    spec = dict(prompt_len=prompt.shape[1], steps=6, draft_layers=1, draft_len=2)
    for label, extra, args_ in (("speculative", {}, (prompt,)),
                                ("speculative sampled", dict(temperature=0.8), (prompt, key))):
        a = tspec.make_generate_speculative(cfg, **spec, **extra)(one["bf16"], *args_)
        b = tspec.make_generate_speculative(cfg, mesh, **spec, **extra)(meshed["bf16"], *args_)
        out[label] = torch.equal(a, b)
    a = _engines(one, cfg, None)
    b = _engines(meshed, cfg, mesh)
    for name in a:
        out[f"engine {name}"] = a[name][0] == b[name][0]
    return out


def _rank_speculative(rank, args):
    fields, tree, prompt = args
    mesh = _mesh()
    cfg = tb.BurninConfig(**fields)
    params = _shards(tree, cfg, mesh)
    spec = tspec.make_generate_speculative(cfg, mesh, prompt_len=prompt.shape[1], steps=6,
                                           draft_layers=1, draft_len=2, with_stats=True)
    toks, rounds, healthy = spec(params, torch.tensor(prompt))
    return toks.numpy(), rounds, bool(healthy)


def _rank_families(rank, args):
    ranks = list(range(dist.get_world_size()))
    out = {}
    for name, int8 in args:
        r = tmodels.serve_family(name, ranks, steps=4, prompt_len=8, int8=int8, device="cpu")
        out[(name, int8)] = dataclasses.asdict(r)
    return out


# --- the parent's side ----------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


@pytest.fixture(scope="module")
def jmesh(devices):
    return jlogical(devices, **MESH)


@pytest.fixture(scope="module")
def inputs(jmesh):
    """Every case's reference config, weights (as numpy) and inputs."""
    tiny = jb.BurninConfig(**TINY).scaled_to(jmesh)
    tiny_params = jb.init_params(tiny, jax.random.PRNGKey(0))
    serve = jb.BurninConfig(**SERVE)
    serve_params = jb.init_params(serve, jax.random.PRNGKey(1))
    scfg = jb.BurninConfig(**STANZA).scaled_to(jmesh)
    rcfg = jb.BurninConfig(**STANZA, rope=True).scaled_to(jmesh)
    sparams = jb.init_params(scfg)
    rng = np.random.RandomState(2)
    return {
        "tiny": (tiny, {"bf16": tiny_params, "int8": jq.quantize_params(tiny_params)}),
        "prompt": rng.randint(0, tiny.vocab, (tiny.batch, PLEN)).astype(np.int32),
        "nxt": rng.randint(0, tiny.vocab, (tiny.batch,)).astype(np.int32),
        "serve": (serve, {"bf16": serve_params, "int8": jq.quantize_params(serve_params)}),
        "stanza": (scfg, {"bf16": sparams, "int8": jq.quantize_params(sparams)}),
        "rope": (rcfg, jb.init_params(rcfg)),
        "one_prompt": rng.randint(0, serve.vocab, (4, 8)).astype(np.int32),
    }


FAMILY_CASES = [("dense", False), ("flash", False), ("moe", False), ("dense", True),
                ("moe", True), ("long_context", False), ("pipelined", False)]


@pytest.fixture(scope="module")
def ranks(inputs):
    tiny, tiny_trees = inputs["tiny"]
    serve, serve_trees = inputs["serve"]
    scfg, strees = inputs["stanza"]
    rcfg, rtree = inputs["rope"]
    np_trees = {n: _np(t) for n, t in tiny_trees.items()}
    serve_np = {n: _np(t) for n, t in serve_trees.items()}
    jobs = [
        ("logits", _rank_logits, (dataclasses.asdict(tiny), np_trees, inputs["prompt"],
                                  inputs["nxt"])),
        ("stanzas", _rank_stanzas, (dataclasses.asdict(scfg), {n: _np(t) for n, t in
                                                               strees.items()},
                                    dataclasses.asdict(rcfg), _np(rtree))),
        ("engines", _rank_engines, (dataclasses.asdict(serve), serve_np)),
        ("one_rank", _rank_one_rank, (dataclasses.asdict(serve), serve_np,
                                      inputs["one_prompt"])),
        ("speculative", _rank_speculative, (dataclasses.asdict(serve), serve_np["bf16"],
                                            inputs["one_prompt"])),
        ("families", _rank_families, FAMILY_CASES),
    ]
    r = tsh.Ranks(jobs)
    yield r
    r.stop()


def _rank_rows(sizes, rank, batch):
    c = weights._coords(sizes, rank)
    dp = sizes["data"] * sizes["fsdp"]
    n = batch // dp
    b = c["data"] * sizes["fsdp"] + c["fsdp"]
    return slice(b * n, (b + 1) * n)


def _assemble(results, key, batch, sizes=SIZES):
    """The global rows from every rank's (the ranks along ``model`` must
    agree bitwise: their rows are the same)."""
    parts = {}
    for rank, res in enumerate(results):
        sl = _rank_rows(sizes, rank, batch)
        got = key(res)
        if sl.start in parts:
            np.testing.assert_array_equal(parts[sl.start], got)
        parts[sl.start] = got
    return np.concatenate([parts[k] for k in sorted(parts)])


def _walk(jcfg, jparams, prompt, generated, kv_int8=False):
    """The reference's one-device logits that picked each generated token
    of one row, along its own path (prefill, then one-token steps)."""
    cache = jd.init_cache(jcfg, 1, kv_int8)
    logits, cache = jd.decode_forward(jparams, jnp.asarray([prompt], jnp.int32), cache, 0, jcfg)
    rows = [np.asarray(logits[0, -1], np.float32)]
    for i, tok in enumerate(generated[:-1]):
        logits, cache = jd.decode_forward(jparams, jnp.asarray([[tok]], jnp.int32), cache,
                                          len(prompt) + i, jcfg)
        rows.append(np.asarray(logits[0, -1], np.float32))
    return rows


def assert_tokens_near(jcfg, jparams, prompts, got, want, kv_int8=False, sampled=None):
    """Per row: ``got`` equals ``want``, or first differs where the
    reference's one-device logits along ``want``'s path are at a near-tie
    (``sampled``: ``(T, seeds)``, the perturbed logits of each row's key
    at that position).  Returns how many rows diverged."""
    diverged = 0
    for r, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        g, w = list(g), list(w)
        assert len(g) == len(w), (prompt, g, w)
        i = next((j for j in range(len(w)) if g[j] != w[j]), None)
        if i is None:
            continue
        diverged += 1
        row = _walk(jcfg, jparams, list(prompt), w, kv_int8)[i]
        tol = NEAR_TIE
        if sampled is not None:
            temp, seeds = sampled
            key = prng.fold_in(prng.key(torch.tensor([seeds[r]])), torch.tensor([len(prompt) + i]))
            row = row / temp + prng.gumbel(key, (row.shape[-1],)).numpy()[0]
            tol = NEAR_TIE / temp
        top2 = np.sort(row)[-2:]
        assert top2[1] - top2[0] <= tol, (prompt, i, g, w, top2)
    return diverged


def _jspecs(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


class TestSpecs:
    @pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
    def test_quant_param_specs_equal_the_references(self, jmesh, moe):
        jcfg = jb.BurninConfig(**TINY, moe_experts=4 if moe else 0).scaled_to(jmesh)
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        assert tq.quant_param_specs(tcfg, SIZES) == _jspecs(jq.quant_param_specs(jcfg, jmesh))

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_cache_and_pool_specs_equal_the_references(self, int8):
        jcfg = jb.BurninConfig(**TINY)
        tcfg = tb.BurninConfig(**TINY)
        assert td.cache_spec(tcfg, int8) == _jspecs(jd.cache_spec(jcfg, int8))
        assert tp.block_pool_spec(tcfg, int8) == _jspecs(jp.block_pool_spec(jcfg, int8))

    def test_shard_params_cuts_a_quantized_tree_by_its_specs(self, inputs):
        """Each rank's int8 shards are the whole tree's blocks, dtypes kept
        (int8 values, f32 scales); the ranks' shards cover the tree."""
        jcfg, trees = inputs["tiny"]
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        whole = weights.params_from_numpy(_np(trees["int8"]), device="cpu")
        specs = tq.quant_param_specs(tcfg, SIZES)
        for rank in range(WORLD):
            shard = weights.shard_params(whole, tcfg, SIZES, rank, device="cpu")
            coords = weights._coords(SIZES, rank)
            q, s = shard["layers"]["wqkv"]["q"], shard["layers"]["wqkv"]["s"]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            sl = spmd.local_slices(specs["layers"]["wqkv"]["q"], whole["layers"]["wqkv"]["q"].shape,
                                   SIZES, coords)
            assert torch.equal(q, whole["layers"]["wqkv"]["q"][sl])
            assert tuple(shard["embed"]["q"].shape) == (jcfg.vocab // 2, jcfg.d_model // 2)
            assert tuple(shard["embed"]["s"].shape) == (jcfg.vocab // 2, 1)

    def test_one_rank_shards_are_the_tree_itself(self, inputs):
        jcfg, trees = inputs["tiny"]
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        whole = weights.params_from_numpy(_np(trees["bf16"]), device="cpu")
        one = weights.shard_params(whole, tcfg, {"data": 1, "fsdp": 1, "model": 1}, 0,
                                   device="cpu")
        assert one["layers"]["wqkv"].data_ptr() == whole["layers"]["wqkv"].data_ptr()
        assert one["layers"]["wqkv"].dtype == torch.bfloat16


class TestLogits:
    @pytest.mark.parametrize("name", ["bf16", "int8"])
    def test_prefill_and_step_within_the_references_mesh_tolerance(self, ranks, inputs, jmesh,
                                                                   name):
        jcfg, trees = inputs["tiny"]
        jparams = trees[name]
        prompt, nxt = inputs["prompt"], inputs["nxt"]
        int8 = name == "int8"
        spec = jd.cache_spec(jcfg, int8)

        def put(leaf):
            if int8:
                return {k: jax.device_put(a, NamedSharding(jmesh, spec[k])) for k, a in leaf.items()}
            return jax.device_put(leaf, NamedSharding(jmesh, spec))

        cache = {n: put(leaf) for n, leaf in jd.init_cache(jcfg, jcfg.batch, int8).items()}
        want, cache = jd.decode_forward(jparams, jnp.asarray(prompt), cache, 0, jcfg, mesh=jmesh)
        want_step, _ = jd.decode_forward(jparams, jnp.asarray(nxt)[:, None], cache,
                                         jnp.int32(PLEN), jcfg, mesh=jmesh)
        results = ranks.get()
        b = jcfg.batch
        local = results[0]["logits"][name][2]
        assert local == (jcfg.n_layers, b // 4, jcfg.seq, jcfg.n_heads // 2, jcfg.d_head)
        got = _assemble(results, lambda r: r["logits"][name][0], b)
        got_step = _assemble(results, lambda r: r["logits"][name][1], b)
        np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(got_step, np.asarray(want_step), atol=LOGIT_TOL, rtol=0)


class TestStanzas:
    """The "serve padded decode", "serve int8 weights+kv" and rope serve
    stanzas of __graft_entry__.dryrun_multichip, at their own config.

    The tokens are held to the reference's one-device generation of the
    same config and weights: its jitted ``make_generate_padded`` on the
    mesh departs from that beyond rounding (row 3 of the bf16 stanza
    takes 118 at its third token where its one-device generation, and
    its own jitted mesh `decode_forward` over the same tokens, rank 86
    first by far more than a near-tie), so its mesh tokens are no
    oracle."""

    @pytest.mark.parametrize("name", ["bf16", "int8", "rope"])
    def test_healthy_and_tokens_match_the_references(self, ranks, inputs, name):
        results = ranks.get()
        got, healthy = results[0]["stanzas"][name]
        for res in results:  # the global tokens on every rank
            np.testing.assert_array_equal(res["stanzas"][name][0], got)
        if name == "rope":
            jcfg, jparams = inputs["rope"]
            gen = jd.make_generate(jcfg, prompt_len=8, steps=4, with_health=True)
            want, jhealthy = gen(jparams, jnp.ones((jcfg.batch, 8), jnp.int32))
            prompts = [[1] * 8] * jcfg.batch
        else:
            jcfg, trees = inputs["stanza"]
            jparams = trees[name]
            gen = jd.make_generate_padded(jcfg, prompt_slots=8, steps=4, with_health=True,
                                          kv_int8=name == "int8")
            lens = np.arange(jcfg.batch) % 8 + 1
            want, jhealthy = gen(jparams, jnp.ones((jcfg.batch, 8), jnp.int32),
                                 jnp.asarray(lens, jnp.int32))
            prompts = [[1] * int(n) for n in lens]
        assert healthy and bool(jhealthy)
        assert got.shape == (jcfg.batch, 12) == tuple(want.shape)
        np.testing.assert_array_equal(got[:, :8], np.asarray(want)[:, :8])
        assert_tokens_near(jcfg, jparams, prompts, got[:, 8:], np.asarray(want)[:, 8:],
                           kv_int8=name == "int8")


class TestEngines:
    CASES = ["paged prefix", "rows prefix", "paged sampled", "rows sampled", "paged 3 slots",
             "rows chunked", "paged int8", "preemption"]

    @pytest.fixture(scope="class")
    def one_device(self, inputs):
        jcfg, trees = inputs["serve"]
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        params = {n: weights.params_from_numpy(_np(t), device="cpu") for n, t in trees.items()}
        return _engines(params, tcfg, None)

    @pytest.mark.parametrize("name", CASES)
    def test_mesh_engine_drains_like_the_one_device_engine(self, ranks, inputs, one_device,
                                                           name):
        """Every rank serves the same tokens (global every step); they are
        the port's one-device engine's up to a near-tie of the
        reference's logits; prefix hits, preemptions and the victims
        agree across ranks, clocks skewed on odd ranks."""
        jcfg, trees = inputs["serve"]
        results = ranks.get()
        got, _, hits, preempted, victims = results[0]["engines"][name]
        for res in results:
            assert res["engines"][name][0] == got
            assert res["engines"][name][2:] == (hits, preempted, victims)
        want, _, want_hits, want_preempted, _ = one_device[name]
        reqs = {"paged prefix": _prefix_stream(), "rows prefix": _prefix_stream(),
                "preemption": PREEMPT_REQS}.get(name)
        if reqs is None:
            reqs = _mixed_stream(jcfg.vocab, *{"paged 3 slots": (4, 5), "rows chunked": (5, 6),
                                               "paged int8": (4, 7)}.get(name, (6, 4)))
        assert [len(t) for t, _ in got] == [r[1] for r in reqs]
        sampled = (SAMPLED["temperature"], SEEDS) if "sampled" in name else None
        int8 = name == "paged int8"
        assert_tokens_near(jcfg, trees["int8" if int8 else "bf16"], [r[0] for r in reqs],
                           [t for t, _ in got], [t for t, _ in want], kv_int8=int8,
                           sampled=sampled)
        if "prefix" in name:
            assert hits > 0 and hits == want_hits
        if name == "preemption":
            assert preempted >= 1 and want_preempted >= 1
        if "sampled" in name:
            for (_, lp), (_, wlp) in zip(got, want):
                assert len(lp) == len(wlp) and all(np.isfinite(lp))

    @pytest.mark.parametrize("name", [c for c in CASES if "rows" not in c])
    def test_pool_replicas_equal_after_every_tick(self, ranks, name):
        """The pool is whole over data x fsdp: the ranks of one ``model``
        index hold bitwise the same pool after every tick."""
        results = ranks.get()
        by_model = {}
        for rank, res in enumerate(results):
            m = weights._coords(SIZES, rank)["model"]
            digests = res["engines"][name][1]
            assert digests
            by_model.setdefault(m, digests)
            assert digests == by_model[m], (name, rank)


class TestOneRank:
    def test_every_mesh_path_is_bitwise_the_one_device_path(self, ranks):
        got = ranks.get()[0]["one_rank"]
        assert got and all(got.values()), {k: v for k, v in got.items() if not v}


class TestSpeculative:
    def test_greedy_on_the_mesh_matches_make_generate(self, ranks, inputs):
        jcfg, trees = inputs["serve"]
        prompt = inputs["one_prompt"]
        results = ranks.get()
        toks, rounds, healthy = results[0]["speculative"]
        for res in results:
            np.testing.assert_array_equal(res["speculative"][0], toks)
            assert res["speculative"][1] == rounds
        assert healthy and 1 <= rounds <= 6 and toks.shape == (4, 8 + 6)
        want = np.asarray(jd.make_generate(jcfg, prompt_len=8, steps=6)(
            trees["bf16"], jnp.asarray(prompt)))
        assert_tokens_near(jcfg, trees["bf16"], prompt.tolist(), toks[:, 8:], want[:, 8:])


class TestFamilies:
    @pytest.mark.parametrize("name,int8", FAMILY_CASES,
                             ids=[f"{n}-{'int8' if q else 'bf16'}" for n, q in FAMILY_CASES])
    def test_serve_family_over_the_family_mesh(self, ranks, devices, name, int8):
        results = ranks.get()
        got = results[0]["families"][(name, int8)]
        assert all(res["families"][(name, int8)]["ok"] == got["ok"] for res in results)
        if name in ("long_context", "pipelined"):
            want = jmodels.serve_family(name, devices, steps=4, prompt_len=8, int8=int8)
            assert not got["ok"] and not want.ok
            assert got["error"] == want.error, (got["error"], want.error)
        else:
            assert got["ok"], got
            assert got["error"] == "" and (got["batch"], got["steps"]) == (8, 4)

    def test_validate_serves_a_family_over_several_devices(self, capsys):
        """``--family moe --serve --int8`` on 4 local devices: one worker a
        device, moe on `moe_mesh` (4 divides by 4); the reference's JSON."""
        import json

        code = tvalidate.main(["--family", "moe", "--serve", "--int8"], device="cpu",
                              local_devices=4)
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert code == 0 and rep["ok"] and rep["family"] == "moe", rep
        assert (rep["batch"], rep["steps"]) == (8, 12)


class _FakePlace:
    """A place on data 1, fsdp 2, model 2 whose collectives the test fakes."""

    sizes = {"data": 1, "fsdp": 2, "model": 2}
    coords = {"data": 0, "fsdp": 0, "model": 0}

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return None


class TestCollectivesHandNcclContiguousTensors:
    """NCCL refuses a non-contiguous tensor; gloo takes one.  A mesh
    decode step (paged and rows, bf16 and int8) and a step's picks run
    here against fakes that check every tensor they are handed (values
    are not checked: the fakes tile, sum or pass through)."""

    @pytest.fixture
    def fakes(self, monkeypatch):
        handed = []

        def all_gather_into_tensor(out, x, group=None):
            handed.append(x.is_contiguous() and out.is_contiguous())
            out.copy_(torch.cat([x] * (out.shape[0] // x.shape[0])))

        def reduce_scatter_tensor(out, x, group=None):
            handed.append(x.is_contiguous() and out.is_contiguous())
            out.copy_(x[:out.shape[0]])

        def all_reduce(x, group=None):
            handed.append(x.is_contiguous())

        monkeypatch.setattr(dist, "all_gather_into_tensor", all_gather_into_tensor)
        monkeypatch.setattr(dist, "reduce_scatter_tensor", reduce_scatter_tensor)
        monkeypatch.setattr(dist, "all_reduce", all_reduce)
        return handed

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    def test_mesh_steps_and_picks(self, fakes, int8):
        cfg = tb.BurninConfig(**SERVE)
        whole = tb.init_params(cfg, device="cpu")
        whole = tq.quantize_params(whole) if int8 else weights.cast_matrices(whole)
        params = weights.shard_params(whole, cfg, _FakePlace.sizes, 0, device="cpu")
        rows = td._Rows(_FakePlace(), 4)
        assert rows.split and (rows.lo, rows.hi) == (0, 2)
        pool = tp.init_block_pool(cfg, 9, 4, int8, device="cpu")
        pool = {n: ({k: t[..., :2, :].contiguous() for k, t in leaf.items()} if int8
                    else leaf[..., :2, :].contiguous()) for n, leaf in pool.items()}
        tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
        pos = torch.tensor([3, 5, 0, 7], dtype=torch.int32)
        table = torch.arange(1, 9, dtype=torch.int32).view(4, 2)
        logits, _ = tp._paged_step(params, tok, pool, table, pos, cfg, "gather", rows)
        assert logits.shape == (4, cfg.vocab)  # the group's rows: data is 1
        cache = td.init_cache(cfg, 2, int8, device="cpu")
        cache = {n: ({k: t[..., :2, :].contiguous() for k, t in leaf.items()} if int8
                     else leaf[..., :2, :].contiguous()) for n, leaf in cache.items()}
        logits, _ = td._step_rows(params, tok, cache, pos, cfg, rows)
        pick = td._make_pick(True, 0.8)
        picks = pick(logits, prng.key(3), rows)
        both = rows.to_global(torch.stack([picks.float(), logits[:, 0]], dim=1))
        assert both.shape == (4, 2)
        assert fakes and all(fakes)

"""DeepSeek-V3's block in the port (`models.mla_moe`, `moe.topk_moe_mlp`,
`kernels.mla_decode`) against the plain float32 reference
(`tests/ref_mla_moe.py`) at a tiny size on the CPU: d 64, 4 heads,
latent 32, rope 16, no-rope 32, value 32, 8 experts top-2 and 1 shared,
one dense layer and two expert layers.

Tolerances and their reasons:

- the port against the f32 reference: ``2**-5 * max|ref|`` on logits.
  The port rounds every product's output and the latent cache to bf16
  (8 bits, a relative 2**-9 a rounding) and three layers compound it;
  the measured gap is about a third of the tolerance.  The reference is
  handed the port's expert choices, so a near-tie flip does not count.
- the absorbed form against the expanded one: ``2**-5`` of the output's
  scale.  The expanded form rounds each head's keys, values and scores
  to bf16, the absorbed one ``q_lat`` and ``o_lat``: a few bf16 ulps
  (2**-8 each) apart; measured 0.4-0.7 % on five seeds.
- K3's plain version against the dense absorbed contraction:
  ``2**-6`` of the output's scale.  Both read the same bf16 latents and
  round the probabilities to bf16 at the same point; only the order of
  the f32 sums and the online softmax's rescaling differ.
- routing: exact (both are the same f32 operations on the same input).
"""

import dataclasses
import math

import pytest
import torch

import ref_mla_moe as ref
from tpu_dra_torch.models import mla_moe as mm
from tpu_dra_torch.parallel import moe
from tpu_dra_torch.parallel.kernels.mla_decode import mla_decode, mla_decode_plain, split_count
from tpu_dra_torch.parallel.serve import ServeEngine

CFG = mm.MlaMoeConfig(
    vocab_size=256, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
    num_experts_per_tok=2, first_k_dense_replace=1, max_position_embeddings=512,
)
CD = dataclasses.asdict(CFG)
W = 8
ENGINE = dict(slots=3, prompt_slots=32, max_new_cap=24, prefix_window=W, device="cpu")


@pytest.fixture(scope="module")
def params():
    return mm.init_params(CFG, 3)


@pytest.fixture(scope="module")
def served(params):
    """One engine's run of four requests of every length class, per backend."""
    out = {}
    g = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (5, 17, 32, 9)]
    for backend in ("gather", "cuda"):
        eng = ServeEngine(params, CFG, record_routes=True, with_logprobs=True, **ENGINE)
        eng.attn_backend = backend  # "cuda" on CPU tensors runs K3's plain version
        ids = [eng.submit(p, m) for p, m in zip(prompts, (20, 9, 24, 3))]
        eng.run()
        out[backend] = ([eng.request(i) for i in ids], eng.moe_assignments())
    return out


def _tol(x):
    return 2 ** -5 * x.abs().max().item()


def test_forward_matches_the_reference(params):
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
    logits, routes = mm.forward(params, toks, CFG)
    assert routes.shape == (2, 40, 2, 2)
    for b in range(2):
        want = ref.forward(params, toks[b], CD, routes=routes[b])
        assert (logits[b] - want).abs().max().item() < _tol(want)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
def test_engine_prefill_then_decode_matches_the_full_forward(params, served, backend):
    """Every served token's logprob against the reference's full forward
    over the prompt and the served tokens, following the engine's routes:
    prompts shorter than, equal to and across the W=8 blocks, decode
    crossing block boundaries at per-row positions."""
    reqs, _ = served[backend]
    for r in reqs:
        assert r.routes.shape == (len(r.prompt) + len(r.tokens) - 1, 2, 2)
        want = ref.forward(params, torch.tensor(r.prompt + r.tokens[:-1]), CD, routes=r.routes)
        lg = want[len(r.prompt) - 1:]
        served_tok = torch.tensor(r.tokens)
        gap = lg.max(-1).values - lg.gather(-1, served_tok[:, None])[:, 0]
        assert gap.max().item() < _tol(lg)
        lp = torch.log_softmax(lg, -1).gather(-1, served_tok[:, None])[:, 0]
        assert (torch.tensor(r.logprobs) - lp).abs().max().item() < _tol(lg)


def test_in_flight_routes_are_the_fed_prefix(params):
    """`ServeEngine.request_routes` of a request mid-decode: its fed
    positions' choices, which hold the served prefix to the reference and
    are the head of the routes it finishes with."""
    g = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (6, 13)]
    eng = ServeEngine(params, CFG, record_routes=True, **ENGINE)
    ids = [eng.submit(p, 16) for p in prompts]
    for _ in range(5):
        eng.tick()
    mid = {}
    for i in ids:
        r = eng.request(i)
        assert not r.done and r.routes is None
        got = eng.request_routes(i)
        assert got.shape == (len(r.prompt) + len(r.tokens) - 1, 2, 2)
        mid[i] = (got, list(r.tokens))
        want = ref.forward(params, torch.tensor(r.prompt + r.tokens[:-1]), CD, routes=got)
        lg = want[len(r.prompt) - 1:]
        served_tok = torch.tensor(r.tokens)
        gap = lg.max(-1).values - lg.gather(-1, served_tok[:, None])[:, 0]
        assert gap.max().item() < _tol(lg)
    eng.run()
    for i, (got, toks) in mid.items():
        r = eng.request(i)
        assert r.tokens[:len(toks)] == toks
        assert torch.equal(eng.request_routes(i)[:got.shape[0]], got)
    assert eng.request_routes(10 ** 6) is None
    eng.close()


def test_seam_logits_at_per_row_positions(params):
    """The seam's own prefill and decode logits, rows at different
    positions across block boundaries, against the reference's."""
    seam = mm.PagedMlaMoe(CFG, slots=2, positions=48, record_routes=True)
    served_params = seam.prepare(params)
    pool = seam.init_pool(16, W, kv_int8=False, device="cpu", mesh=None)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 256, (n,), generator=g) for n in (7, 13)]
    table = torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], dtype=torch.int32)
    prefill = seam.make_prefill(16, W)
    seqs = []
    for row, p in enumerate(prompts):
        padded = torch.zeros((1, 16), dtype=torch.long)
        padded[0, :len(p)] = p
        last, pool = prefill(served_params, padded, torch.tensor([len(p)]), pool,
                             table[row:row + 1])
        seam.admitted(row, len(p))
        want = ref.forward(params, p, CD, routes=seam.routes[row, :len(p)])
        assert (last[0] - want[-1]).abs().max().item() < _tol(want)
        seqs.append(p.tolist())
    for backend in ("gather", "cuda"):
        s = [list(x) for x in seqs]
        pool_b = {"latent": pool["latent"].clone()}
        for _ in range(6):  # row 0 crosses 8 and row 1 crosses 16
            tok = torch.tensor([x[-1] for x in s])
            pos = torch.tensor([len(x) - 1 for x in s], dtype=torch.int32)
            logits, pool_b = seam.decode(served_params, tok, pool_b, table, pos, backend)
            for b in range(2):
                routes = seam.routes[b, :len(s[b])]
                want = ref.forward(params, torch.tensor(s[b]), CD, routes=routes)[-1]
                assert (logits[b] - want).abs().max().item() < _tol(want), (backend, b)
                s[b].append(int(want.argmax()))


def test_absorbed_decode_matches_the_expanded_attention(params):
    layer = mm.PagedMlaMoe(CFG, slots=1, positions=8, record_routes=False).prepare(
        params)["layers"][1]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 64, generator=g)
    cos, sin = mm.rope_tables(torch.arange(12)[None], CFG)
    q_nope, q_pe, lat = mm._project(layer, x, CFG, cos, sin)
    mask = torch.ones(12, 12, dtype=torch.bool).tril()[None]
    expanded = mm._attend_expanded(layer, q_nope, q_pe, lat, mask, CFG)[:, -1].float()
    q_lat = torch.einsum("bhn,hnl->bhl", q_nope[:, -1], layer["uk_t"])
    q = torch.cat([q_lat, q_pe[:, -1]], -1)
    o_lat = mm.absorbed_dense(q, lat, torch.tensor([11, 11]), CFG)
    absorbed = torch.einsum("bhl,hlv->bhv", o_lat.to(torch.bfloat16), layer["uv"])
    absorbed = absorbed.reshape(2, -1).float()
    assert (absorbed - expanded).abs().max().item() < _tol(expanded)


@pytest.mark.parametrize("rows,maxpos", [(5, 40), (1, 47), (3, 0)])
def test_k3_plain_matches_the_dense_absorbed_contraction(rows, maxpos):
    g = torch.Generator().manual_seed(rows)
    pool = torch.randn(20, W, 48, generator=g).to(torch.bfloat16)
    q = torch.randn(rows, 4, 48, generator=g).to(torch.bfloat16)
    table = torch.randint(1, 20, (rows, 6), generator=g, dtype=torch.int32)
    pos = torch.randint(0, maxpos + 1, (rows,), generator=g, dtype=torch.int32)
    got = mla_decode(q, pool, table, pos, v_dim=32, scale=CFG.scale)
    assert torch.equal(got, mla_decode_plain(q, pool, table, pos, v_dim=32, scale=CFG.scale))
    lat = pool[table.long()].reshape(rows, 6 * W, 48)
    want = mm.absorbed_dense(q, lat, pos, CFG)
    assert (got - want).abs().max().item() < 2 ** -6 * want.abs().max().item()


def test_split_count_fills_the_card():
    assert split_count(128, 22) == 4 and split_count(1, 22) == 16 and split_count(1, 3) == 4
    assert split_count(300, 22) == 1


def test_bias_picks_experts_but_does_not_weigh_them(params):
    layer = params["layers"][1]
    h = torch.randn(64, 64, generator=torch.Generator().manual_seed(6))
    topi, w = moe.route_topk(layer, h, 2, CFG.routed_scaling_factor)
    unbiased = torch.topk(torch.sigmoid(h @ layer["router"]), 2, dim=-1).indices
    assert (topi.sort(-1).values != unbiased.sort(-1).values).any()
    scores = torch.sigmoid(h @ layer["router"])
    assert torch.allclose(w, scores.gather(-1, topi) / scores.gather(-1, topi).sum(-1, True)
                          * 2.446)
    assert torch.allclose(w.sum(-1), torch.full((64,), 2.446))


def test_expert_layer_matches_a_token_by_token_sum(params):
    layer = params["layers"][2]
    h = torch.randn(10, 64, generator=torch.Generator().manual_seed(7))
    out, topi, counts = moe.topk_moe_mlp(layer, h, k=2, scale=2.446)
    assert counts.sum().item() == 20 and counts.tolist() == torch.bincount(
        topi.reshape(-1), minlength=8).tolist()
    _, w = moe.route_topk(layer, h, 2, 2.446)
    hb = h.to(torch.bfloat16)
    for t in range(10):
        want = moe.swiglu(hb[t:t + 1], layer["ws_gate"], layer["ws_up"], layer["ws_down"]).float()
        for j in range(2):
            e = int(topi[t, j])
            y = moe.swiglu(hb[t:t + 1], layer["we_gate"][e].T, layer["we_up"][e].T,
                           layer["we_down"][e].T)
            want = want + w[t, j] * y.float()
        assert torch.allclose(out[t], want[0], rtol=1e-5, atol=1e-5)


def test_tally_counts_decode_rows_and_real_prompt_tokens(served):
    reqs, tally = served["gather"]
    assert len(tally) == 2 and all(len(row) == 8 for row in tally)
    prompt = sum(len(r.prompt) for r in reqs)
    # Four warm prefills' real tokens, and every decode step's 3 rows.
    per_layer = [sum(row) for row in tally]
    assert per_layer[0] == per_layer[1]
    assert per_layer[0] >= 2 * prompt and (per_layer[0] - 2 * prompt) % (2 * 3) == 0


@pytest.mark.parametrize("kwargs,words", [
    ({"kv_int8": True}, "bf16 only"),
    ({"prefix_cache_slots": 2}, "no prefix cache"),
    ({"host_kv_blocks": 4}, "no swap tier"),
    ({"kv_layout": "rows"}, "paged"),
    ({"tier": "prefill"}, "mono engine"),
])
def test_engine_refuses_what_the_latent_model_does_not_serve(params, kwargs, words):
    with pytest.raises(ValueError, match=words):
        ServeEngine(params, CFG, **{**ENGINE, **kwargs})


def test_param_count_of_the_published_config():
    # 15.96 B parameters, as the published widths give them.
    assert math.isclose(mm.param_count(mm.MlaMoeConfig()) / 1e9, 15.96, abs_tol=0.01)

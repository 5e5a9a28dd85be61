"""K3, the paged latent-attention decode kernel (`kernels.mla_decode`),
and the DeepSeek-V3-block engine on the card (tests marked ``cuda``;
each skips where torch sees no CUDA device).  This module imports
neither JAX nor the reference package, so it runs on a GPU host:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mla_cuda.py -q

K3 is held against its plain version at Moonlight's widths (16 heads,
latent 512 and rope 64, blocks of 128) with 128, 8 and 1 rows, so with
4 and 16 programs a row and the in-launch combine; a second launch must
be bitwise the first (the combine's order is fixed, and the arrival
counters are left at zero).  Tolerance ``2**-7`` of the output's scale:
both read the same bf16 values, but the kernel rescales its online
softmax every 64 positions and the plain version every 128, so the
probabilities round to bf16 at other points (measured 2**-9.6).

A 27-layer engine at narrow widths then serves a few requests: one K3
launch a layer a decode step, every prefill window replayed from its
captured graph, and the served tokens and their logprobs against the
plain f32 reference (`ref_mla_moe`, TF32 off) that follows the engine's
expert choices: every gap and logprob within ``2**-5`` of the logits'
scale (the port's bf16 products and latent cache, as on the CPU).  The
engine captures its windows and its step when it is built, its first
served step is a replay, and the capture's warm-up leaves the expert
tally and the routes at zero.  The decode step replayed from its
captured graphs is held to the same step run op by op."""

import dataclasses

import pytest
import torch

import ref_mla_moe as ref
from tpu_dra_torch.models import mla_moe as mm
from tpu_dra_torch.parallel.kernels import mla_decode as k3
from tpu_dra_torch.parallel.serve import ServeEngine

NARROW = mm.MlaMoeConfig(
    vocab_size=512, hidden_size=128, num_hidden_layers=27, num_attention_heads=4,
    kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32,
    intermediate_size=256, moe_intermediate_size=64, n_routed_experts=16,
    n_shared_experts=2, num_experts_per_tok=6, first_k_dense_replace=1,
    max_position_embeddings=512,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is a Triton kernel, built and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,maxpos", [(128, 2816), (128, 900), (8, 2816), (1, 300)])
def test_k3_matches_its_plain_version(cuda, rows, maxpos):
    g = torch.Generator(device=cuda).manual_seed(rows + maxpos)
    pool = torch.randn(2817, 128, 576, device=cuda, generator=g).to(torch.bfloat16)
    q = torch.randn(rows, 16, 576, device=cuda, generator=g).to(torch.bfloat16)
    table = torch.randint(1, 2817, (rows, 22), device=cuda, generator=g, dtype=torch.int32)
    pos = torch.randint(0, maxpos, (rows,), device=cuda, generator=g, dtype=torch.int32)
    want = k3.mla_decode_plain(q, pool, table, pos, v_dim=512, scale=192 ** -0.5)
    before = k3.mla_decode.launches
    got = k3.mla_decode(q, pool, table, pos, v_dim=512, scale=192 ** -0.5)
    again = k3.mla_decode(q, pool, table, pos, v_dim=512, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert k3.mla_decode.launches == before + 2
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() < 2 ** -7 * want.abs().max().item()


@pytest.mark.cuda
def test_engine_launches_k3_once_a_layer_and_replays_every_window(cuda):
    params = mm.init_params(NARROW, 7, cuda)
    opts = dict(slots=4, prompt_slots=128, max_new_cap=64, prefix_window=32)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 512, (n,), generator=g).tolist() for n in (1, 31, 32, 33, 128)]
    eng = ServeEngine(params, NARROW, device=cuda, record_routes=True, with_logprobs=True, **opts)
    before = k3.mla_decode.launches
    ids = [eng.submit(p, 20) for p in prompts]
    eng.run()
    assert k3.mla_decode.launches - before == 27 * eng.device_steps
    stats = eng.prefix_stats
    assert stats["prefill_windows_eager"] == 0 and stats["prefill_windows_graph"] == 5 * 4
    card = [eng.request(i) for i in ids]
    eng.close()
    for r in card:
        assert r.routes.shape == (len(r.prompt) + 19, 26, 6)
        with torch.no_grad(), ref.strict_fp32():
            want = ref.forward(params, torch.tensor(r.prompt + r.tokens[:-1], device=cuda),
                               dataclasses.asdict(NARROW), routes=r.routes)[len(r.prompt) - 1:]
        served = torch.tensor(r.tokens, device=cuda)[:, None]
        gap = want.max(-1).values - want.gather(-1, served)[:, 0]
        assert gap.max().item() < 2 ** -5 * want.abs().max().item()
        lp = torch.log_softmax(want, -1).gather(-1, served)[:, 0].cpu()
        tol = 2 ** -5 * want.abs().max().item()
        assert (torch.tensor(r.logprobs) - lp).abs().max().item() < tol


@pytest.mark.cuda
def test_engine_captures_at_build_and_replays_its_first_step(cuda):
    """Both graphs exist once the engine is built, the tally and the
    routes read zero there, and every decode step from the first is a
    replay: the tally then sums the prompt's real tokens and every slot's
    row a step, six assignments each, and nothing of the warm-up."""
    params = mm.init_params(NARROW, 5, cuda)
    eng = ServeEngine(params, NARROW, device=cuda, record_routes=True, slots=4,
                      prompt_slots=128, max_new_cap=64, prefix_window=32)
    assert eng._prefill_graphs is not None and eng._step_graphs is not None
    model = eng._model
    assert not model.tally.any() and not model.routes.any()
    before = k3.mla_decode.launches
    rid = eng.submit(list(range(1, 40)), 3)
    eng.run()
    steps = eng.device_steps
    stats = eng.prefix_stats
    assert steps >= 2 and (stats["decode_steps_graph"], stats["decode_steps_eager"]) == (steps, 0)
    assert k3.mla_decode.launches - before == 27 * steps
    assert (model.tally.sum(-1) == 6 * (39 + 4 * steps)).all()
    assert eng.request(rid).routes.shape == (39 + 2, 26, 6)
    eng.close()


@pytest.mark.cuda
def test_decode_graphs_replay_the_eager_step(cuda):
    """The decode step replayed from its captured graphs against the same
    step run op by op from the same pool, three steps, rows at positions
    across block boundaries: the logits within ``2**-5`` of their scale
    in every row whose experts both chose alike, each layer's tally the
    same total, K3 counted 27 a step.  Not bitwise: the expert combine's
    ``index_add_`` sums a token's routed outputs with atomics, in an order
    that varies from run to run, eager or replayed (0.018 at logits of
    scale 4 seen), and a difference that small can flip a near-tied
    expert choice, which changes the row's MLP output whole (so each step
    starts both from the same pool, and a row whose choices differ is
    left out)."""
    params = mm.init_params(NARROW, 11, cuda)
    eng = ServeEngine(params, NARROW, device=cuda, record_routes=True, slots=4,
                      prompt_slots=128, max_new_cap=128, prefix_window=32, kv_blocks=40)
    eager = mm.PagedMlaMoe(NARROW, slots=4, positions=256, record_routes=True)
    seams, served = [eng._model, eager], eng.params
    pools = [eng._pool, eager.init_pool(40, 32, kv_int8=False, device=cuda, mesh=None)]
    g = torch.Generator(device=cuda).manual_seed(12)
    pools[0]["latent"].copy_(torch.randn(pools[0]["latent"].shape, generator=g, device=cuda))
    table = torch.arange(1, 33, dtype=torch.int32, device=cuda).view(4, 8)
    pos = torch.tensor([30, 31, 95, 200], dtype=torch.int32, device=cuda)
    tok = torch.tensor([5, 17, 400, 3], dtype=torch.int32, device=cuda)
    rows = torch.arange(4, device=cuda)
    before = k3.mla_decode.launches
    for step in range(3):
        pools[1]["latent"].copy_(pools[0]["latent"])
        graphed, path = eng._decode_paged(tok, table, pos + step)
        assert path == "graph"
        graphed = graphed.clone()
        want, _ = eager.decode(served, tok, pools[1], table, pos + step, "cuda")
        at = (pos + step).long()
        chose = [s.routes[rows, at].sort(-1).values for s in seams]
        alike = (chose[0] == chose[1]).flatten(1).all(-1)
        assert alike.any(), step
        gap = (graphed - want).abs()[alike].max().item()
        assert gap < 2 ** -5 * want.abs().max().item(), step
        tok = want.argmax(-1).int()
    torch.cuda.synchronize()
    assert k3.mla_decode.launches - before == 2 * 27 * 3
    assert torch.equal(seams[0].tally.sum(-1), seams[1].tally.sum(-1))
    assert (seams[0].tally.sum(-1) == 4 * 6 * 3).all()

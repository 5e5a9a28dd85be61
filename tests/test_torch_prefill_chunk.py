"""The engine's windowed admission prefill (tpu_dra_torch/parallel/
serve.py ``ServeEngine(prefill_chunk=)``) against the reference's
(tpu_dra/parallel/serve.py) on the reference's weights: on rows the B=1
admission prefill runs in ``prefill_chunk``-token windows, on paged the
chunk is the block size.  Greedy tokens and finish reasons must be
identical (the windowed prefill is token-exact against the one-shot
one on one device); the knob's checks raise the reference's messages."""

import numpy as np
import pytest
import torch

from test_torch_burnin import CONFIGS, both_params
from test_torch_moe import moe_configs
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel.serve import ServeEngine

torch.set_num_threads(2)

SPEC = dict(slots=3, prompt_slots=8, max_new_cap=6)


def _stream(vocab, n=7, seed=11):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, vocab, int(rng.randint(1, 9)))],
             int(rng.randint(1, 7))) for _ in range(n)]


def _drain(eng, reqs):
    ids = [eng.submit(p, b) for p, b in reqs]
    done = {r.id: r for r in eng.run()}
    return [(list(done[i].tokens), done[i].finish_reason) for i in ids]


@pytest.mark.parametrize("layout,chunk", [("rows", 4), ("rows", 2), ("paged", 4)],
                         ids=["rows-4", "rows-2", "paged-4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunked_engine_matches_the_references(name, layout, chunk):
    jcfg, tcfg = CONFIGS[name]
    jparams, tparams = both_params(jcfg)
    reqs = _stream(jcfg.vocab)
    kw = dict(SPEC, kv_layout=layout, prefill_chunk=chunk)
    want = _drain(JaxEngine(jparams, jcfg, attn_backend="gather", **kw), reqs)
    eng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    got = _drain(eng, reqs)
    assert got == want
    if layout == "paged":
        assert eng.block_size == chunk  # prefix_window defaults to the chunk
    # One device: the windowed prefill is the one-shot one's tokens.
    assert _drain(ServeEngine(tparams, tcfg, device="cpu", **dict(SPEC, kv_layout=layout)),
                  reqs) == got


def test_rows_prefix_window_defaults_to_the_chunk():
    jcfg, tcfg = CONFIGS["dense"]
    _, tparams = both_params(jcfg)
    eng = ServeEngine(tparams, tcfg, device="cpu", kv_layout="rows", prefix_cache_slots=2,
                      prefill_chunk=2, **SPEC)
    assert eng.block_size == 2


def _refusal(engine_cls, params, cfg, **kw):
    with pytest.raises(ValueError) as e:
        engine_cls(params, cfg, **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(kv_layout="rows", prefill_chunk=3),
                                dict(kv_layout="rows", prefill_chunk=0),
                                dict(kv_layout="paged", prefill_chunk=4, prefix_window=2),
                                dict(kv_layout="paged", prefill_chunk=3)],
                         ids=["not-dividing", "zero", "paged-off-grid", "paged-not-dividing"])
def test_refusals_are_the_references(kw):
    jcfg, tcfg = CONFIGS["dense"]
    jparams, tparams = both_params(jcfg)
    want = _refusal(JaxEngine, jparams, jcfg, **SPEC, **kw)
    assert _refusal(ServeEngine, tparams, tcfg, device="cpu", **SPEC, **kw) == want


def test_moe_refuses_a_chunk_with_the_references_message():
    jcfg, tcfg = moe_configs()
    jparams, tparams = both_params(jcfg)
    kw = dict(SPEC, kv_layout="rows", prefill_chunk=4)
    want = _refusal(JaxEngine, jparams, jcfg, **kw)
    assert _refusal(ServeEngine, tparams, tcfg, device="cpu", **kw) == want
    assert "prefill_chunk is not supported with moe_experts > 0" in want
    # The one-shot chunk is no window, and serves.
    ServeEngine(tparams, tcfg, device="cpu", **dict(kw, prefill_chunk=8)).close()

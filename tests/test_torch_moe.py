"""The port's switch-routed expert MLP (tpu_dra_torch/parallel/moe.py) and
the MoE model around it (burnin.py, weights.py, quant.py) against the
reference (tpu_dra/parallel/moe.py, burnin.py, quant.py) on the
reference's own weights, at a tiny width (4 experts).

Tolerances:

- ``moe_mlp``: output within one bf16 ulp (``atol 2**-9``, ``rtol
  2**-7``), the expert choice equal, the load-balance term within
  ``1e-6`` relative (f32 means summed in another order);
- the forward's logits as stated in test_torch_burnin (2 bf16 ulps);
- training as stated in test_torch_train (the reference's step compiled
  with ``xla_allow_excess_precision`` off), except a column of an
  expert's ``w1e`` gradient whose leaky ReLU sits at a near-tie: a kept
  token's pre-activation within ``2**-7`` of the layer's largest, so
  that an input one bf16 ulp apart (the two sides round the attention
  before it their own way) can put it on the other side of 0 and change
  its derivative from 1 to 0.01 (`assert_grads_close`).

Routing near-ties: the router's f32 product is summed in another order
by XLA and by torch, so a token whose top-2 router probabilities lie
within about 1e-6 of each other could go to another expert on each side,
and its output would then differ by far more than an ulp.  Every test
that routes records the smallest top-2 margin the port's router saw
(`router_margins`), prints it, and asserts it above ``ROUTER_TIE``; no
tolerance is widened for a tie."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_burnin import assert_logits_close, both_params
from test_torch_train import first_moment, ulps2
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import decode as jd
from tpu_dra.parallel import moe as jm
from tpu_dra.parallel import quant as jq
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import moe as tm
from tpu_dra_torch.parallel import quant as tq
from tpu_dra_torch.parallel.weights import state_from_numpy

torch.set_num_threads(2)

_MOE_SHAPE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4,
                  moe_experts=4)
ROUTER_TIE = 1e-5
ULP_TOL = dict(atol=2 ** -9, rtol=2 ** -7)


def moe_configs(**overrides):
    fields = {**_MOE_SHAPE, **overrides}
    return jb.BurninConfig(**fields), tb.BurninConfig(**fields)


@contextlib.contextmanager
def router_margins():
    """Records every routing the port's model does inside the block
    (`burnin.moe_mlp`): ``(layer, h, capacity, margin)`` in call order,
    ``margin`` the smallest top-2 router probability margin of the call;
    yields the list.  On exit the smallest margin is printed and must
    clear ``ROUTER_TIE``."""
    calls = []
    real = tb.moe_mlp

    def recording(layer, h, config, capacity=None):
        with torch.no_grad():
            top2 = torch.topk(tm.route(layer, h), 2, dim=-1).values
            margin = float((top2[..., 0] - top2[..., 1]).min())
            calls.append(({k: v.detach() for k, v in layer.items()}, h.detach(), capacity, margin))
        return real(layer, h, config, capacity)

    tb.moe_mlp = recording
    try:
        yield calls
    finally:
        tb.moe_mlp = real
    assert calls, "nothing was routed"
    smallest = min(call[3] for call in calls)
    print(f"smallest router top-2 margin: {smallest:.3e}")
    assert smallest > ROUTER_TIE, smallest


def leaky_ties(call, config, rel=2 ** -7):
    """The (expert, column) pairs of one routing call whose leaky ReLU is
    at a near-tie: some kept token's bf16 pre-activation ``h @ w1e[e]``
    within ``rel`` of the call's largest in magnitude."""
    layer, h, capacity, _ = call
    C = tm.expert_capacity(config) if capacity is None else capacity
    with torch.no_grad():
        choice = tm.route(layer, h).argmax(-1)
        onehot = torch.nn.functional.one_hot(choice, config.moe_experts)
        place = (torch.cumsum(onehot, dim=1) - 1).gather(-1, choice[..., None])[..., 0]
        kept = place < C
        pre = torch.einsum("bsd,bsdf->bsf", h, layer["w1e"].to(torch.bfloat16)[choice]).float()
    near = (pre.abs() <= rel * pre.abs().max()) & kept[..., None]
    return {(int(choice[b, s]), int(f)) for b, s, f in near.nonzero().tolist()}


def assert_grads_close(jtree, ttree, calls, config):
    """Gradient leaves within 2 bf16 ulps of each leaf's largest
    magnitude (test_torch_train's tolerance), except ``w1e`` columns of
    a leaky-ReLU near-tie (`leaky_ties` of the layer's forward call, the
    first ``n_layers`` of ``calls``), each of which must be one."""
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    tleaves = tb._leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for (path, w), g in zip(jleaves, tleaves):
        w, g = np.asarray(w), g.numpy()
        tol = ulps2(w)
        if jax.tree_util.keystr(path).endswith("['w1e']"):
            off = np.abs(g - w) > tol  # (L, E, D, F)
            for l, e, f in {(l, e, f) for l, e, _, f in np.argwhere(off)}:
                assert (e, f) in leaky_ties(calls[l], config), (l, e, f)
                g[l, e, :, f] = w[l, e, :, f]
                print(f"w1e gradient: layer {l} expert {e} column {f} at a leaky ReLU near-tie")
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=jax.tree_util.keystr(path))


def _layer0(jparams, tparams):
    names = ("router", "w1e", "w2e")
    return ({n: jparams["layers"][n][0] for n in names},
            {n: tparams["layers"][n][0] for n in names})


class TestMoeMlp:
    @pytest.mark.parametrize("capacity", [1.25, 0.5, 8.0])
    def test_matches_reference(self, capacity):
        """Output, choice and load-balance term of one MLP call; at
        capacity 0.5 tokens are dropped (their output rows zero), at 8.0
        none is."""
        jcfg, tcfg = moe_configs(moe_capacity=capacity)
        jparams, tparams = both_params(jcfg, seed=1)
        jlayer, tlayer = _layer0(jparams, tparams)
        h = np.random.RandomState(5).randn(3, jcfg.seq, jcfg.d_model).astype(np.float32)
        jh = jnp.asarray(h, jnp.bfloat16)
        th = torch.tensor(np.asarray(jh.astype(jnp.float32))).to(torch.bfloat16)
        want, want_aux = jm.moe_mlp(jlayer, jh, jcfg, lambda kind, a: a)
        with router_margins():
            got, got_aux = tb.moe_mlp(tlayer, th, tcfg)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, **ULP_TOL)
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
        jprobs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jh.astype(jnp.float32),
                                           jlayer["router"]), axis=-1)
        tchoice = tm.route(tlayer, th).argmax(-1).numpy()
        np.testing.assert_array_equal(tchoice, np.asarray(jprobs.argmax(-1)))
        dropped = int((np.abs(want).sum(-1) == 0).sum())
        assert (dropped > 0) == (capacity < 1), dropped
        assert int((got.float().abs().sum(-1) == 0).sum()) == dropped

    def test_capacity_matches_reference(self):
        for seq, experts, factor, groups in [(32, 4, 1.25, 1), (1024, 4, 1.25, 1), (7, 3, 0.5, 1),
                                             (1024, 4, 1.25, 4), (5, 8, 0.1, 1)]:
            jcfg, tcfg = moe_configs(seq=seq, moe_experts=experts, moe_capacity=factor)
            assert tm.expert_capacity(tcfg, groups) == jm.expert_capacity(jcfg, groups)


class TestMoeModel:
    @pytest.mark.parametrize("capacity", [1.25, 0.5])
    def test_forward_logits_and_aux_match_reference(self, capacity):
        jcfg, tcfg = moe_configs(moe_capacity=capacity)
        jparams, tparams = both_params(jcfg, seed=2)
        tokens = np.random.RandomState(4).randint(0, jcfg.vocab, (jcfg.batch, jcfg.seq))
        want, want_aux = jax.jit(
            lambda p, t: jb.forward(p, t, jcfg, return_aux=True)
        ).lower(jparams, jnp.asarray(tokens, jnp.int32)).compile(
            {"xla_allow_excess_precision": False})(jparams, jnp.asarray(tokens, jnp.int32))
        with torch.no_grad(), router_margins():
            got, got_aux = tb.forward(tparams, torch.tensor(tokens, dtype=torch.int32), tcfg,
                                      return_aux=True)
        assert_logits_close(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
        plain = tb.forward(tparams, torch.tensor(tokens, dtype=torch.int32), tcfg)
        assert torch.equal(plain, got)

    def test_train_steps_match_reference(self):
        """Loss (the load-balance term included) and one momentum step's
        gradients from the reference's initial state, then 3 steps."""
        jcfg, tcfg = moe_configs()
        jstep, jstate = jb.make_train_step(jcfg)
        tstate = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        tstep, _ = tb.make_train_step(tcfg, device="cpu")
        assert sorted(tstate[0]["layers"]) == ["ln1", "ln2", "router", "w1e", "w2e", "wo", "wqkv"]
        tokens = np.random.RandomState(3).randint(0, jcfg.vocab, (jcfg.batch, jcfg.seq))
        jtok, ttok = jnp.asarray(tokens, jnp.int32), torch.tensor(tokens, dtype=torch.int32)
        jstep = jstep.lower(jstate, jtok).compile({"xla_allow_excess_precision": False})
        want, got = [], []
        with router_margins() as calls:
            for i in range(3):
                jstate, jloss = jstep(jstate, jtok)
                tstate, tloss = tstep(tstate, ttok)
                want.append(float(jloss))
                got.append(float(tloss))
                if i == 0:
                    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
                    assert_grads_close(first_moment(jstate[1]), first_moment(tstate[1]), calls,
                                       tcfg)
        np.testing.assert_allclose(got, want, rtol=1e-2)
        assert got[-1] < got[0]

    def test_aux_term_is_in_the_loss(self):
        _, tcfg = moe_configs()
        params = tb.init_params(tcfg, device="cpu")
        tokens = tb.sample_tokens(tcfg, device="cpu")
        with torch.no_grad():
            logits, aux = tb.forward(params, tokens, tcfg, return_aux=True)
            loss = tb._loss(params, tokens, tcfg)
            zmax = logits[:, :-1].amax(-1, keepdim=True)
            lse = torch.log(torch.exp(logits[:, :-1] - zmax).sum(-1)) + zmax[..., 0]
            picked = logits[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
            ce = torch.mean(lse - picked)
        assert float(aux) > 0
        torch.testing.assert_close(loss, ce + tcfg.moe_aux_weight * aux)

    def test_init_params_tree_matches_reference(self):
        jcfg, tcfg = moe_configs()
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jb.init_params(jcfg))
        got = tb.init_params(tcfg, device="cpu")
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
        assert all(t.dtype == torch.float32 for t in tb._leaves(got))


class TestPaddedRouting:
    def test_padded_rows_match_unpadded(self):
        """Trailing pads never move a real token's queue place: rows of a
        padded batch at tight capacity generate what each row alone does,
        on the port and on the reference."""
        jcfg, tcfg = moe_configs(seq=24, batch=2)
        jparams, tparams = both_params(jcfg, seed=3)
        lens, P, steps = [4, 8], 8, 5
        rng = np.random.RandomState(40)
        prompt = np.full((2, P), 11, np.int32)
        rows = []
        for b, ln in enumerate(lens):
            rows.append(rng.randint(0, jcfg.vocab, (1, ln)).astype(np.int32))
            prompt[b, :ln] = rows[-1][0]
        with router_margins():
            got = td.make_generate_padded(tcfg, prompt_slots=P, steps=steps)(
                tparams, torch.tensor(prompt), torch.tensor(lens, dtype=torch.int32)).numpy()
            want = np.asarray(jd.make_generate_padded(jcfg, prompt_slots=P, steps=steps)(
                jparams, jnp.asarray(prompt), jnp.asarray(lens, jnp.int32)))
            for b, ln in enumerate(lens):
                alone = td.generate(tparams, torch.tensor(rows[b]), steps, tcfg).numpy()[0]
                np.testing.assert_array_equal(got[b, P:], alone[ln:])
        np.testing.assert_array_equal(got, want)


class TestQuantizedExperts:
    def test_experts_quantized_router_kept(self):
        """`quantize_params` covers ``w1e``/``w2e`` per expert and output
        channel, as the reference's does, and leaves the router f32."""
        jcfg, tcfg = moe_configs()
        jparams = jb.init_params(jcfg, jax.random.PRNGKey(4))
        host = jax.tree_util.tree_map(np.asarray, jparams)
        tparams, _ = state_from_numpy((host, host), tcfg, device="cpu")  # f32, as the reference's
        want = jq.quantize_params(jparams)
        got = tq.quantize_params(tparams)
        for name in ("w1e", "w2e"):
            assert tq.is_quantized_leaf(got["layers"][name])
            np.testing.assert_array_equal(got["layers"][name]["q"].numpy(),
                                          np.asarray(want["layers"][name]["q"]))
            np.testing.assert_allclose(got["layers"][name]["s"].numpy(),
                                       np.asarray(want["layers"][name]["s"]), rtol=1e-7)
        router = got["layers"]["router"]
        assert router is tparams["layers"]["router"] and router.dtype == torch.float32
        assert not jq.is_quantized_leaf(want["layers"]["router"])

"""The port's single-device training (tpu_dra_torch/parallel/burnin.py,
weights.state_from_numpy, mfu.py, models/) against the reference's
(tpu_dra/parallel/burnin.py, mfu.py, models/) from the reference's own
initial state, on the same numpy tokens.

The reference's step is compiled with ``xla_allow_excess_precision``
off: XLA on the CPU otherwise skips some bf16 roundings of the dense
attention inside its fusions (the gradients then drift by up to about
12 bf16 ulps), while the port rounds where the reference's source does.
Its flash kernel runs in Pallas interpret mode, as its own tests run it.

Tolerances: the first loss within ``1e-3`` relative; each gradient leaf
after step 1 (the momentum tree, or AdamW's first moment, which hold it)
within 2 bf16 ulps of the leaf's largest magnitude (bf16 products summed
in another order); the losses of 3 steps within ``1e-2`` relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import mfu as jmfu
from tpu_dra_torch import models
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import mfu as tmfu
from tpu_dra_torch.parallel.weights import state_from_numpy

torch.set_num_threads(2)

_SHAPE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4)
_ADAMW = dict(optimizer="adamw", lr_schedule="cosine", warmup_steps=1, total_steps=4,
              grad_clip_norm=0.5, weight_decay=0.1)
CASES = {
    "dense": {},
    # seq 256: the model path runs two 128-blocks.
    "flash_seq256": dict(flash_attention=True, seq=256, batch=2),
    "rope_flash": dict(rope=True, flash_attention=True),
    "adamw_cosine_clip_flash": dict(_ADAMW, flash_attention=True),
    "adamw_cosine_clip_dense": dict(_ADAMW),
}


def configs(**overrides):
    fields = {**_SHAPE, **overrides}
    return jb.BurninConfig(**fields), tb.BurninConfig(**fields)


def ulps2(want):
    """2 bf16 ulps at the largest magnitude of ``want``."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def first_moment(opt):
    return opt["m"] if isinstance(opt, dict) and "t" in opt else opt


class TestTrainStep:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_steps_match_reference(self, name):
        jcfg, tcfg = configs(**CASES[name])
        jstep, jstate = jb.make_train_step(jcfg)
        tstate = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        tstep, _ = tb.make_train_step(tcfg, device="cpu")
        tokens = np.random.RandomState(3).randint(0, jcfg.vocab, (jcfg.batch, jcfg.seq))
        jtok, ttok = jnp.asarray(tokens, jnp.int32), torch.tensor(tokens, dtype=torch.int32)
        jstep = jstep.lower(jstate, jtok).compile({"xla_allow_excess_precision": False})
        want, got = [], []
        for i in range(3):
            jstate, jloss = jstep(jstate, jtok)
            tstate, tloss = tstep(tstate, ttok)
            want.append(float(jloss))
            got.append(float(tloss))
            if i == 0:
                np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
                jleaves = jax.tree_util.tree_leaves_with_path(first_moment(jstate[1]))
                tleaves = tb._leaves(first_moment(tstate[1]))
                assert len(jleaves) == len(tleaves)
                for (path, w), g in zip(jleaves, tleaves):
                    w = np.asarray(w)
                    assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
                    np.testing.assert_allclose(
                        g.numpy(), w, rtol=0, atol=ulps2(w), err_msg=jax.tree_util.keystr(path)
                    )
        np.testing.assert_allclose(got, want, rtol=1e-2)
        assert got[-1] < got[0]
        if tcfg.optimizer == "adamw":
            assert int(tstate[1]["t"]) == 3 and tstate[1]["t"].dtype == torch.int32

    def test_state_is_updated_in_place(self):
        _, tcfg = configs()
        step, state = tb.make_train_step(tcfg, device="cpu")
        params, opt = state
        embed = params["embed"]
        before = embed.detach().clone()
        tokens = tb.sample_tokens(tcfg, device="cpu")
        state2, loss = step(state, tokens)
        assert state2 is state and state2[0]["embed"] is embed
        assert not torch.equal(embed.detach(), before)
        assert loss.dim() == 0 and not loss.requires_grad


class TestScheduleAndClip:
    @pytest.mark.parametrize(
        "overrides",
        [dict(optimizer="adamw"), dict(optimizer="adamw", warmup_steps=3),
         dict(optimizer="adamw", lr_schedule="cosine", total_steps=10),
         dict(optimizer="adamw", lr_schedule="cosine", warmup_steps=2, total_steps=9)],
        ids=["constant", "warmup", "cosine", "warmup_cosine"],
    )
    def test_schedule_lr_matches_reference(self, overrides):
        jcfg, tcfg = configs(**overrides)
        for t in range(12):
            want = float(jb.schedule_lr(jcfg, jnp.int32(t)))
            got = tb.schedule_lr(tcfg, torch.tensor(t, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)

    @pytest.mark.parametrize("clip", [0.5, 1e3])
    def test_clip_grads_matches_reference(self, clip):
        rng = np.random.RandomState(4)
        tree = {"a": rng.randn(3, 4).astype(np.float32),
                "b": {"c": rng.randn(5).astype(np.float32), "d": rng.randn(2, 2).astype(np.float32)}}
        want = jax.tree_util.tree_leaves(jb._clip_grads(jax.tree_util.tree_map(jnp.asarray, tree), clip))
        grads = [torch.tensor(a) for a in jax.tree_util.tree_leaves(tree)]
        got = tb._clip_grads(grads, clip)
        assert got is grads
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    @pytest.mark.parametrize(
        "overrides",
        [dict(optimizer="sgd"), dict(lr_schedule="linear"), dict(warmup_steps=2),
         dict(optimizer="adamw", lr_schedule="cosine"),
         dict(optimizer="adamw", lr_schedule="cosine", warmup_steps=4, total_steps=4)],
        ids=["optimizer", "schedule", "momentum_warmup", "no_horizon", "horizon_in_warmup"],
    )
    def test_optimizer_config_rejected_as_the_reference_does(self, overrides):
        jcfg, tcfg = configs(**overrides)
        with pytest.raises(ValueError) as want:
            jb.make_train_step(jcfg, with_state=False)
        with pytest.raises(ValueError) as got:
            tb.make_train_step(tcfg, device="cpu")
        assert str(got.value) == str(want.value)


class TestTokensAndState:
    def test_sample_tokens_walk_and_noise(self):
        _, tcfg = configs(batch=8, seq=128, vocab=256)
        a = tb.sample_tokens(tcfg, device="cpu")
        b = tb.sample_tokens(tcfg, torch.Generator().manual_seed(42), device="cpu")
        assert a.dtype == torch.int32 and tuple(a.shape) == (8, 128)
        assert torch.equal(a, b)
        assert int(a.min()) >= 0 and int(a.max()) < 256
        walk = ((a[:, :-1].long() + 17) % 256 == a[:, 1:].long()).float().mean()
        assert 0.85 < float(walk) < 0.99  # 5% noise breaks about 10% of the steps

    @pytest.mark.parametrize("optimizer", ["momentum", "adamw"])
    def test_state_from_numpy_keeps_f32_masters(self, optimizer):
        jcfg, tcfg = configs(optimizer=optimizer)
        jstate = jb._init_state(jcfg)
        params, opt = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
        assert all(t.dtype == torch.float32 for t in tb._leaves(params))
        np.testing.assert_array_equal(params["layers"]["wqkv"].numpy(), np.asarray(jstate[0]["layers"]["wqkv"]))
        if optimizer == "adamw":
            assert set(opt) == {"m", "v", "t"} and opt["t"].dtype == torch.int32
            assert opt["m"]["embed"] is not opt["v"]["embed"]
        else:
            assert all(float(t.abs().max()) == 0.0 for t in tb._leaves(opt))

    @pytest.mark.parametrize("optimizer", ["momentum", "adamw"])
    def test_init_state_matches_reference_tree(self, optimizer):
        jcfg, tcfg = configs(optimizer=optimizer)
        want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), jb._init_state(jcfg))
        got = tb._init_state(tcfg, "cpu")
        shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
        assert shapes == want


class TestTrain:
    def test_report_fields(self):
        _, tcfg = configs()
        report = tb.train(tcfg, steps=3, device="cpu")
        assert report.ok and report.error == ""
        assert report.steps == 3 and report.loss_last < report.loss_first
        assert report.step_seconds_p50 > 0
        assert report.tokens_per_second == pytest.approx(tcfg.batch * tcfg.seq / report.step_seconds_p50)

    def test_reports_instead_of_raising(self):
        _, tcfg = configs(optimizer="sgd")
        report = tb.train(tcfg, steps=3, device="cpu")
        assert not report.ok and report.steps == 0 and "optimizer must be" in report.error

    def test_assemble_report_matches_reference(self):
        jcfg, tcfg = configs()
        losses, times = [3.0, 2.5, float("nan"), 2.0], [9.0, 0.2, 0.4, 0.3]
        for ls in (losses, [3.0, 2.5, 2.4, 2.0], [2.0, 2.5]):
            want = dataclasses.asdict(jb.assemble_train_report(jcfg, ls, times[:len(ls)]))
            got = dataclasses.asdict(tb.assemble_train_report(tcfg, ls, times[:len(ls)]))
            assert got == want


class TestFamilies:
    @pytest.mark.parametrize("name", ["dense", "flash", "rope", "moe"])
    def test_single_device_families_train(self, name):
        report = models.train_family(name, steps=3, device="cpu", **_SHAPE)
        assert report.ok and report.error == "", report
        assert report.steps == 3

    @pytest.mark.parametrize(
        "name,reason", [("moe", "moe_experts"), ("pipelined", "pipeline_stages"),
                        ("long_context", "ring_attention")]
    )
    def test_rejected_families_report_the_config_reason(self, name, reason):
        if name == "moe":
            # Ported: the family trains on one device, and a field that
            # stays refused still comes back as the config's reason.
            report = models.train_family(name, steps=3, device="cpu", **_SHAPE)
            assert report.ok and report.error == "", report
            report = models.train_family(name, steps=3, device="cpu", pipeline_stages=2)
            assert not report.ok and "pipeline_stages" in report.error and reason not in report.error
            return
        if name == "long_context":
            # Ported on a mesh: the config takes it, and one device is
            # refused with the reference's forward's message.
            report = models.train_family(name, steps=3, device="cpu")
            assert not report.ok and report.steps == 0
            assert report.error == "ValueError: context-parallel attention requires a device mesh"
            assert models.family_config(name).ring_attention
            return
        if name == "pipelined":
            # Ported on a mesh of ranks: one device is refused with the
            # reference's words for one device (its pipeline_mesh error).
            from tpu_dra import models as jmodels

            report = models.train_family(name, steps=3, device="cpu")
            want = jmodels.train_family(name, jax.devices()[:1], steps=3)
            assert not report.ok and report.steps == 0 and not want.ok
            assert report.error == want.error == (
                "ValueError: 1 devices not divisible into 2 stages x 1 model")
            assert models.family_config(name).pipeline_stages == 2
            return
        report = models.train_family(name, steps=3, device="cpu")
        assert not report.ok and report.steps == 0
        assert report.error.startswith("ValueError") and reason in report.error

    def test_family_presets_match_reference(self):
        from tpu_dra import models as jmodels

        assert sorted(models.FAMILIES) == sorted(jmodels.FAMILIES)
        for name in ("dense", "flash", "rope", "moe"):
            want = dataclasses.asdict(jmodels.family_config(name, seq=64))
            assert dataclasses.asdict(models.family_config(name, seq=64)) == want

    def test_unknown_family_raises(self):
        with pytest.raises(ValueError, match="unknown model family"):
            models.train_family("nope", device="cpu")


class TestMfu:
    @pytest.mark.parametrize("hbm_gib", [8, 16, 80, 96])
    def test_sizing_and_counts_match_reference(self, hbm_gib):
        want = jmfu.chip_sized_config(hbm_gib)
        got = tmfu.chip_sized_config(hbm_gib)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tmfu.param_count(got) == jmfu.param_count(want)
        assert tmfu.train_flops_per_step(got) == jmfu.train_flops_per_step(want)

    def test_full_width_config_is_the_slice_size(self):
        c = tmfu.chip_sized_config(80)
        assert (c.vocab, c.d_model, c.n_heads, c.d_ff, c.n_layers, c.seq, c.batch) == (
            32768, 4096, 32, 16384, 8, 1024, 16)
        assert 1.7e9 < tmfu.param_count(c) < 1.8e9

    def test_measure_on_cpu_reports_no_utilization(self):
        _, tcfg = configs()
        report = tmfu.measure_mfu(tcfg, peak_tflops=0.0, warmup_steps=1, timed_steps=2, device="cpu")
        assert report.ok and report.error == "" and report.platform == "cpu"
        assert report.mfu == 0.0 and report.step_seconds > 0
        assert report.flops_per_step == tmfu.train_flops_per_step(tcfg)

    def test_measure_reports_instead_of_raising(self):
        _, tcfg = configs(optimizer="sgd")
        report = tmfu.measure_mfu(tcfg, peak_tflops=989.0, device="cpu")
        assert not report.ok and "optimizer must be" in report.error

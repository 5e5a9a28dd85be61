"""The port's checkpoints (tpu_dra_torch/parallel/ckpt.py) against the
reference's (tpu_dra/parallel/ckpt.py): the directory logic on the same
trees (complete steps, the newest one, orphans and marker-less
directories skipped), the run metadata read across the two packages, and
the port's own contract — a bitwise round trip (momentum and AdamW with
its step count), a resumed run's losses bitwise equal to an
uninterrupted one's, the fall-back past a torn step, the idempotent
re-save and the replacement of a marker-less occupant.

Every comparison is exact: there is no arithmetic to round."""

import json
import os

import pytest
import torch

from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import ckpt as jc
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import ckpt as tc

torch.set_num_threads(2)

SMALL = dict(n_layers=1, seq=32, d_model=32, d_ff=64, n_heads=4, batch=8, vocab=64)
ADAMW = dict(SMALL, optimizer="adamw", lr_schedule="cosine", warmup_steps=1, total_steps=6)

# Directory trees: names made as directories (a marker inside when the
# name is in `marked`), plus stray files.
TREES = {
    "empty": ([], [], []),
    "complete": (["1", "2", "10"], ["1", "2", "10"], []),
    "orphans": (["3", ".tmp.4.deadbeef", ".tmp.9.0badc0de"], ["3", ".tmp.4.deadbeef"], []),
    "markerless": (["5", "7", "8"], ["5", "8"], []),
    "non_numeric": (["6", "latest", "v2", "-1", "0"], ["6", "latest", "v2", "-1", "0"],
                    ["runmeta.json", "11"]),
}


def make_tree(root, name):
    dirs, marked, files = TREES[name]
    os.makedirs(root, exist_ok=True)
    for d in dirs:
        os.makedirs(os.path.join(root, d))
        if d in marked:
            with open(os.path.join(root, d, tc.COMPLETE_MARKER), "w") as f:
                f.write(d)
    for f in files:
        with open(os.path.join(root, f), "w") as fh:
            fh.write("{}")


def leaves(state):
    params, opt = state
    return tb._leaves(params) + tb._leaves(opt)


def assert_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


class TestDirectoryLogic:
    @pytest.mark.parametrize("name", sorted(TREES))
    def test_steps_equal_the_references(self, tmp_path, name):
        make_tree(tmp_path, name)
        assert tc.complete_steps(tmp_path) == jc.complete_steps(tmp_path)
        assert tc.latest_step(tmp_path) == jc.latest_step(tmp_path)

    def test_absent_directory(self, tmp_path):
        for mod in (tc, jc):
            assert mod.complete_steps(tmp_path / "nope") == []
            assert mod.latest_step(tmp_path / "nope") is None

    def test_the_protocols_names_are_the_references(self):
        assert (tc.COMPLETE_MARKER, tc.RUNMETA) == (jc.COMPLETE_MARKER, jc.RUNMETA)


class TestRunMeta:
    @pytest.mark.parametrize("fields", [SMALL, ADAMW, dict(SMALL, moe_experts=2, rope=True)],
                             ids=["momentum", "adamw", "moe_rope"])
    def test_each_package_reads_the_others(self, tmp_path, fields):
        jc._write_runmeta(tmp_path / "ref", jb.BurninConfig(**fields))
        assert tc._read_runmeta(tmp_path / "ref") == tb.BurninConfig(**fields)
        tc._write_runmeta(tmp_path / "port", tb.BurninConfig(**fields))
        assert jc._read_runmeta(tmp_path / "port") == jb.BurninConfig(**fields)
        with open(tmp_path / "ref" / jc.RUNMETA) as a, open(tmp_path / "port" / tc.RUNMETA) as b:
            assert json.load(a) == json.load(b)

    def test_first_writer_wins(self, tmp_path):
        tc._write_runmeta(tmp_path, tb.BurninConfig(**SMALL))
        tc._write_runmeta(tmp_path, tb.BurninConfig(**dict(SMALL, d_model=64)))
        assert tc._read_runmeta(tmp_path).d_model == 32
        assert tc._read_runmeta(tmp_path / "none") is None


class TestRoundTrip:
    @pytest.mark.parametrize("fields", [SMALL, ADAMW], ids=["momentum", "adamw"])
    def test_bitwise_after_steps(self, tmp_path, fields):
        cfg = tb.BurninConfig(**fields)
        step, state = tb.make_train_step(cfg, "cpu")
        tokens = tb.sample_tokens(cfg, device="cpu")
        for _ in range(2):
            state, _ = step(state, tokens)
        tc.save_state(tmp_path, state, step=2)
        restored = tc.restore_state(tmp_path, cfg, step=2, device="cpu")
        assert_bitwise(state, restored)
        if cfg.optimizer == "adamw":
            assert restored[1]["t"].dtype == torch.int32 and int(restored[1]["t"]) == 2
        assert os.listdir(tmp_path / "2") and not [
            d for d in os.listdir(tmp_path) if d.startswith(".tmp")]

    def test_restore_checks_the_config(self, tmp_path):
        cfg = tb.BurninConfig(**SMALL)
        _, state = tb.make_train_step(cfg, "cpu")
        tc.save_state(tmp_path, state, step=1)
        with pytest.raises(ValueError, match="params.embed"):
            tc.restore_state(tmp_path, tb.BurninConfig(**dict(SMALL, vocab=128)), step=1,
                             device="cpu")
        with pytest.raises(ValueError, match="opt"):
            tc.restore_state(tmp_path, tb.BurninConfig(**dict(SMALL, optimizer="adamw")), step=1,
                             device="cpu")


class TestAtomicCommit:
    def _save_two(self, path):
        cfg = tb.BurninConfig(**SMALL)
        step, state = tb.make_train_step(cfg, "cpu")
        tc.save_state(path, state, step=1)
        state, _ = step(state, tb.sample_tokens(cfg, device="cpu"))
        tc.save_state(path, state, step=2)
        return cfg

    def test_restore_falls_back_past_a_torn_step_and_ignores_orphans(self, tmp_path):
        cfg = self._save_two(tmp_path)
        step1 = tc.restore_state(tmp_path, cfg, step=1, device="cpu")
        os.remove(tmp_path / "2" / tc.STATE_FILE)  # torn under its marker
        os.makedirs(tmp_path / ".tmp.9.deadbeef")  # a save killed midway
        assert tc.latest_step(tmp_path) == 2 == jc.latest_step(tmp_path)
        assert_bitwise(tc.restore_state(tmp_path, cfg, device="cpu"), step1)
        with pytest.raises(FileNotFoundError):
            tc.restore_state(tmp_path, cfg, step=2, device="cpu")

    def test_every_step_torn_raises_with_each_reason(self, tmp_path):
        cfg = self._save_two(tmp_path)
        for s in ("1", "2"):
            os.remove(tmp_path / s / tc.STATE_FILE)
        with pytest.raises(RuntimeError, match="step 2: .*step 1: "):
            tc.restore_state(tmp_path, cfg, device="cpu")

    def test_nothing_complete_raises(self, tmp_path):
        os.makedirs(tmp_path / "3")
        with pytest.raises(FileNotFoundError):
            tc.restore_state(tmp_path, tb.BurninConfig(**SMALL), device="cpu")

    def test_resave_of_a_committed_step_keeps_it(self, tmp_path):
        cfg = tb.BurninConfig(**SMALL)
        step, state = tb.make_train_step(cfg, "cpu")
        tc.save_state(tmp_path, state, step=1)
        first = tc.restore_state(tmp_path, cfg, step=1, device="cpu")
        state, _ = step(state, tb.sample_tokens(cfg, device="cpu"))
        tc.save_state(tmp_path, state, step=1)  # a retried window: the committed one wins
        assert_bitwise(tc.restore_state(tmp_path, cfg, step=1, device="cpu"), first)
        assert sorted(os.listdir(tmp_path)) == ["1"]

    def test_resave_replaces_a_markerless_occupant(self, tmp_path):
        cfg = tb.BurninConfig(**SMALL)
        _, state = tb.make_train_step(cfg, "cpu")
        os.makedirs(tmp_path / "1")
        assert tc.latest_step(tmp_path) is None
        tc.save_state(tmp_path, state, step=1)
        assert tc.latest_step(tmp_path) == 1
        assert_bitwise(tc.restore_state(tmp_path, cfg, step=1, device="cpu"), state)


class TestResume:
    @pytest.mark.parametrize("fields", [SMALL, ADAMW], ids=["momentum", "adamw"])
    @pytest.mark.parametrize("save_every", [None, 1, 2])
    def test_resumed_losses_bitwise_equal_uninterrupted(self, tmp_path, fields, save_every):
        cfg = tb.BurninConfig(**fields)
        final, full = tc.train_with_resume(cfg, tmp_path / "full", steps=5,
                                           save_every=save_every, device="cpu")
        assert final == 5
        s1, first = tc.train_with_resume(cfg, tmp_path / "run", steps=2, save_every=save_every,
                                         device="cpu")
        s2, second = tc.train_with_resume(cfg, tmp_path / "run", steps=3,
                                          save_every=save_every, device="cpu")
        assert (s1, s2) == (2, 5)
        assert first + second == full
        assert tc.latest_step(tmp_path / "run") == 5

    def test_resume_uses_the_frozen_config(self, tmp_path):
        cfg = tb.BurninConfig(**SMALL)
        tc.train_with_resume(cfg, tmp_path, steps=1, device="cpu")
        final, losses = tc.train_with_resume(tb.BurninConfig(**dict(SMALL, d_model=64)),
                                             tmp_path, steps=1, device="cpu")
        assert final == 2 and len(losses) == 1
        assert tc._read_runmeta(tmp_path) == cfg

    def test_resume_builds_no_fresh_state(self, tmp_path, monkeypatch):
        cfg = tb.BurninConfig(**SMALL)
        tc.train_with_resume(cfg, tmp_path, steps=1, device="cpu")
        real = tc.make_train_step
        calls = []

        def recording(config, device, **kw):
            calls.append(kw)
            return real(config, device, **kw)

        monkeypatch.setattr(tc, "make_train_step", recording)
        tc.train_with_resume(cfg, tmp_path, steps=1, device="cpu")
        assert calls == [{"with_state": False}]

    def test_fallback_resume_continues_from_the_step_restored(self, tmp_path):
        cfg = tb.BurninConfig(**SMALL)
        _, full = tc.train_with_resume(cfg, tmp_path / "full", steps=4, save_every=1,
                                       device="cpu")
        tc.train_with_resume(cfg, tmp_path / "run", steps=3, save_every=1, device="cpu")
        os.remove(tmp_path / "run" / "3" / tc.STATE_FILE)
        # Step 3 is torn: the resume restores step 2, and its steps 3 and 4
        # are the uninterrupted run's.  The committed step 3 directory is
        # kept, as the reference keeps a committed directory on a re-save.
        final, losses = tc.train_with_resume(cfg, tmp_path / "run", steps=2, save_every=1,
                                             device="cpu")
        assert final == 4 and losses == full[2:]
        assert tc.complete_steps(tmp_path / "run") == [1, 2, 3, 4]
        assert_bitwise(tc.restore_state(tmp_path / "run", cfg, device="cpu"),
                       tc.restore_state(tmp_path / "full", cfg, step=4, device="cpu"))

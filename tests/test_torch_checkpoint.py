"""The port's checkpoints (``utils/checkpoint.py``) on the CPU: save and
restore are bitwise for the parameters, Adam's moments and step counts, the
training generator and ``state.step``; a truncated newest step falls back
to the older intact one, as the JAX package's does; a config of another
experiment is refused; retention keeps the newest steps and their
manifests only."""

import json
import os

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.utils import checkpoint as jckpt
from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils import checkpoint as ck
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

CFG = ModelConfig(n_hidden_enc=(16,), n_latent_enc=(4,), n_hidden_dec=(16,),
                  n_latent_dec=(784,), likelihood="logits")


def _trained(seed=0, steps=2):
    """A CPU state after `steps` Adam steps on random binary rows."""
    state = ts.create_train_state(seed, CFG, device="cpu")
    step = ts.make_train_step(ObjectiveSpec(name="IWAE", k=3), CFG)
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(steps):
        x = (torch.rand((8, 784), generator=g) > 0.5).float()
        state, _ = step(state, x)
    return state


def _moments(state, key):
    return [state.optimizer.state[p][key] for p in tree_leaves(state.params)]


def _assert_same_state(a, b):
    for name, ta, tb in (
            [("params", x, y) for x, y in zip(tree_leaves(a.params),
                                              tree_leaves(b.params))]
            + [(k, x, y) for k in ("exp_avg", "exp_avg_sq", "step")
               for x, y in zip(_moments(a, k), _moments(b, k))]):
        assert torch.equal(ta, tb), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


def test_save_restore_is_bitwise(tmp_path):
    state = _trained()
    cfg = ExperimentConfig()
    ck.save_checkpoint(str(tmp_path), state.step, state, stage=2,
                       config_json=cfg.to_json(), passes_done=1)
    fresh = ts.create_train_state(5, CFG, device="cpu")
    params_before = [id(p) for p in tree_leaves(fresh.params)]
    step, got, stage, passes_done = ck.restore_latest(
        str(tmp_path), fresh, expect_config_json=cfg.to_json())
    assert (step, stage, passes_done) == (2, 2, 1)
    assert got is fresh and [id(p) for p in tree_leaves(got.params)] == \
        params_before  # restored in place: the optimizer still holds them
    _assert_same_state(state, got)
    # and the two continue identically: the next step's draws and update
    step_fn = ts.make_train_step(ObjectiveSpec(name="IWAE", k=3), CFG)
    x = (torch.rand((8, 784), generator=torch.Generator().manual_seed(9))
         > 0.5).float()
    step_fn(state, x)
    step_fn(got, x)
    _assert_same_state(state, got)


def test_stage_boundary_save_has_no_passes_done(tmp_path):
    state = _trained(steps=1)
    ck.save_checkpoint(str(tmp_path), state.step, state, stage=1)
    assert ck.restore_latest(str(tmp_path), _trained(steps=0))[2:] == (1, None)
    assert ck.restore_latest(str(tmp_path / "none"), state) is None


def test_truncated_newest_falls_back_to_the_intact_one(tmp_path, capsys):
    older, newer = _trained(steps=1), _trained(steps=3)
    ck.save_checkpoint(str(tmp_path), older.step, older, stage=1)
    ck.save_checkpoint(str(tmp_path), newer.step, newer, stage=2)
    assert ck.verify_checkpoint(str(tmp_path), 3) is None
    path = ck.truncate_newest_checkpoint(str(tmp_path))
    assert path.endswith(ck.STATE_FILE) and "/3/" in path
    assert "size mismatch" in ck.verify_checkpoint(str(tmp_path), 3)
    step, got, stage, _ = ck.restore_latest(str(tmp_path), _trained(steps=0))
    assert (step, stage) == (1, 1)
    _assert_same_state(older, got)
    out = capsys.readouterr()
    assert "failed integrity verification" in out.out
    assert "failed integrity verification" in out.err


def test_corrupted_contents_are_detected(tmp_path):
    state = _trained(steps=1)
    ck.save_checkpoint(str(tmp_path), 1, state, stage=1)
    meta = tmp_path / "1" / ck.META_FILE
    text = meta.read_text()
    meta.write_text(text.replace('"stage": 1', '"stage": 7'))
    assert "checksum mismatch" in ck.verify_checkpoint(str(tmp_path), 1)
    assert ck.restore_latest(str(tmp_path), _trained(steps=0)) is None


def test_config_mismatch_raises(tmp_path):
    state = _trained(steps=1)
    ck.save_checkpoint(str(tmp_path), 1, state, stage=1,
                       config_json=ExperimentConfig(k=5).to_json())
    with pytest.raises(ck.CheckpointConfigMismatch, match="different"):
        ck.restore_latest(str(tmp_path), _trained(steps=0),
                          expect_config_json=ExperimentConfig(k=6).to_json())
    # paths and execution knobs are not part of the identity
    other = ExperimentConfig(k=5, log_dir="elsewhere", checkpoint_keep=9,
                             diagnostics=False)
    assert ck.restore_latest(str(tmp_path), _trained(steps=0),
                             expect_config_json=other.to_json()) is not None


def test_config_identity_matches_jax():
    """Both packages compare the same science fields of a stored config,
    defaults filled in for missing keys."""
    cfg = ExperimentConfig(k=7, alpha=0.25, n_hidden_encoder=(5, 6))
    stored = json.loads(cfg.to_json())
    del stored["seed"]
    blob = json.dumps(stored)
    assert ck._config_identity(blob) == jckpt._config_identity(blob)
    assert ck._config_identity("not json") is None


def test_retention_prunes_steps_and_manifests(tmp_path):
    state = _trained(steps=1)
    for step in (1, 2, 3, 4, 5):
        ck.save_checkpoint(str(tmp_path), step, state, stage=1, keep=2)
    assert ck.checkpoint_steps(str(tmp_path)) == [5, 4]
    assert sorted(os.listdir(tmp_path / "manifests")) == ["4.json", "5.json"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]
    # a step saved again is replaced whole
    ck.save_checkpoint(str(tmp_path), 5, _trained(steps=3), stage=2, keep=2)
    step, _, stage, _ = ck.restore_latest(str(tmp_path), _trained(steps=0))
    assert (step, stage) == (5, 2)


def test_fresh_optimizer_state_restores_empty(tmp_path):
    """A state saved before its first step restores with no Adam state, as
    torch's Adam starts."""
    state = _trained(steps=0)
    ck.save_checkpoint(str(tmp_path), 0, state, stage=1)
    got = ck.restore_latest(str(tmp_path), _trained(steps=2))[1]
    assert not got.optimizer.state and got.step == 0
    np.testing.assert_array_equal(
        tree_leaves(got.params)[0].detach().numpy(),
        tree_leaves(state.params)[0].detach().numpy())

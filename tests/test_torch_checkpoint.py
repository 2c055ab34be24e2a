"""The port's checkpoint format (mogasr_torch.utils.checkpoint): a nest of
dicts saved per step and restored without a template, atomic steps, and the
steps a reader sees."""

import json
import os

import numpy as np
import pytest
import torch

from mogasr_torch.utils import checkpoint as ckpt


def test_round_trip_without_template(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"gmm": {"weights": torch.ones(3, 4), "means": torch.arange(24.0).reshape(3, 4, 2)},
            "history": [-30.5, -28.25], "K": 4, "probs": np.full(5, -1.0), "fingerprint": np.asarray([3, 4, 0])}
    ckpt.save_checkpoint(path, tree, step=2)
    ckpt.save_checkpoint(path, {**tree, "K": 8}, step=7)
    assert ckpt.all_steps(path) == [2, 7] and ckpt.latest_step(path) == 7
    back = ckpt.restore_checkpoint(path, None, step=2)
    assert set(back) == set(tree) and set(back["gmm"]) == {"weights", "means"}
    for k in ("weights", "means"):
        assert back["gmm"][k].dtype == np.float32
        np.testing.assert_array_equal(back["gmm"][k], tree["gmm"][k].numpy())
    assert back["history"].dtype == np.float64 and back["history"].tolist() == tree["history"]
    assert int(back["K"]) == 4 and int(ckpt.restore_checkpoint(path)["K"]) == 8
    np.testing.assert_array_equal(back["fingerprint"], tree["fingerprint"])
    with open(os.path.join(path, "step_7", "meta.json")) as f:
        assert json.load(f)["step"] == 7


def test_partial_steps_are_not_seen_and_steps_replace(tmp_path):
    path = str(tmp_path / "ck")
    assert ckpt.latest_step(path) is None and ckpt.all_steps(path) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(path)
    ckpt.save_checkpoint(path, {"x": np.zeros(2)}, step=1)
    # what a save killed before its rename leaves: a temporary directory, or
    # a step directory without meta.json
    os.makedirs(os.path.join(path, ".step_2.tmp"))
    os.makedirs(os.path.join(path, "step_3"))
    np.save(os.path.join(path, "step_3", "state.npy"), np.ones(2))
    assert ckpt.all_steps(path) == [1] and ckpt.latest_step(path) == 1
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(path, {"x": np.ones(2)}, step=1, force=False)
    ckpt.save_checkpoint(path, {"x": np.ones(2)}, step=1)
    np.testing.assert_array_equal(ckpt.restore_checkpoint(path)["x"], np.ones(2))
    assert not [n for n in os.listdir(path) if n.startswith(".step_1.")]


@pytest.mark.parametrize("tree", [{"a/b": 1.0}, {"x": {"y": "text"}}, [1.0]])
def test_rejects_trees_it_cannot_restore(tmp_path, tree):
    with pytest.raises(ValueError):
        ckpt.save_checkpoint(str(tmp_path / "ck"), tree, step=0)
    assert ckpt.all_steps(str(tmp_path / "ck")) == []

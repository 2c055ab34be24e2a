"""The port's top-level exports: every name the reference's
mogasr/__init__.py exports (its config imports and the names its lazy
``__getattr__`` serves) resolves on ``mogasr_torch``; ``init_gmm`` draws from a
torch.Generator around the data statistics, as the reference draws from a
JAX key (equal in distribution, not in values)."""

import ast
import os

import numpy as np
import pytest
import torch

import mogasr_torch
from mogasr_torch.config import GmmConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAITING: set = set()  # names still to be ported: none


def _reference_exports():
    """The names mogasr/__init__.py imports from its config and the string
    constants its __getattr__ compares ``name`` with."""
    tree = ast.parse(open(os.path.join(ROOT, "mogasr", "__init__.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "mogasr.config":
            names.update(a.name for a in node.names)
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) and node.left.id == "name":
            for c in ast.walk(node.comparators[0]):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.add(c.value)
    return names


def test_every_reference_export_resolves():
    names = _reference_exports()
    assert {"TrainConfig", "init_gmm", "pipeline", "corpus_wer", "ctc_loss", "train_bpe", "rnnt_loss",
            "aed_decode_batch", "aed_stream_init", "make_aed_stream_step"} <= names
    assert WAITING <= names
    for name in sorted(names - WAITING):
        assert getattr(mogasr_torch, name) is not None, name
    import mogasr_torch.config as cfg
    import mogasr_torch.pipeline as pipe

    assert mogasr_torch.pipeline is pipe and mogasr_torch.GmmConfig is cfg.GmmConfig
    for name in WAITING:
        with pytest.raises(AttributeError):
            getattr(mogasr_torch, name)


def test_init_gmm_matches_the_reference_in_distribution():
    from mogasr.am.gmm import init_gmm as jax_init_gmm
    import jax

    cfg = GmmConfig(n_states=400, n_components=4, feat_dim=13)
    rng = np.random.default_rng(0)
    mean, var = rng.standard_normal(13).astype(np.float32), (0.5 + rng.random(13)).astype(np.float32)
    g = mogasr_torch.init_gmm(cfg, torch.Generator().manual_seed(0), mean, var, device=torch.device("cpu"))
    j = jax_init_gmm(cfg, jax.random.key(0), mean, var)
    for a, b in zip(g, j):
        assert tuple(a.shape) == tuple(np.asarray(b).shape) and a.dtype == torch.float32
    np.testing.assert_array_equal(g.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(g.vars.numpy(), np.asarray(j.vars))
    # means ~ mean + 0.5 * std * N(0, 1): the same per-dimension moments within sampling error
    z = (g.means.numpy() - mean) / (0.5 * np.sqrt(var))
    jz = (np.asarray(j.means) - mean) / (0.5 * np.sqrt(var))
    for x in (z, jz):
        assert abs(x.mean()) < 0.02 and abs(x.std() - 1.0) < 0.02
    again = mogasr_torch.init_gmm(cfg, torch.Generator().manual_seed(0), mean, var, device=torch.device("cpu"))
    assert torch.equal(again.means, g.means)

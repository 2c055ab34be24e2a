"""The port's neural LMs (mogasr_torch.lm.neural) against the JAX package on
the CPU: the scorer's log-probs of both architectures with the reference's
parameters carried across by ``from_flax`` (1e-5), three training steps on
the reference's batches against its jitted step, perplexity, N-best
rescoring's order, the checkpoint round trip, and the ``train_lm`` twin held
to ``train_nnlm``."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr.config import TrainConfig as JTrainConfig
from mogasr.lm import neural as JNL
from mogasr_torch.am.params import from_flax
from mogasr_torch.config import TrainConfig
from mogasr_torch.lm import neural as NL

TOKENS = ("a", "b", "c", "d", "e")
SEQS = [[0, 1, 2], [3], [], [1, 1, 1, 2, 0], [4, 2]]
LP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def lms(request):
    """The reference's model and parameters at 24 wide, 2 layers (a
    Transformer FFN wider than its model width), and the port's twin."""
    arch = request.param
    jm = JNL.build_nnlm(JNL.LmVocab(TOKENS), JTrainConfig(nn_hidden=24, nn_layers=2), arch)
    jp = jax.jit(jm.init)(jax.random.key(1), jnp.zeros((2, 4), jnp.int32), jnp.asarray([4, 4]))
    tm = NL.build_nnlm(NL.LmVocab(TOKENS), TrainConfig(nn_hidden=24, nn_layers=2), arch)
    tm.load_state_dict(from_flax(tm, jp))
    return arch, jm, jp, tm.eval()


def test_scorer_and_train_steps_match_jax(lms):
    """Sequence log-probs (eos included, padding masked) to 1e-5; then three
    steps of the reference's jitted train step against the port's on the
    same batches: the losses, and the weights after them."""
    arch, jm, jp, tm = lms
    vocab = NL.LmVocab(TOKENS)
    inp, tgt, n = NL.lm_batch(SEQS, vocab, 7)
    want = np.asarray(JNL.make_nnlm_scorer(jm, jp)(jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(n)))
    np.testing.assert_allclose(NL.make_nnlm_scorer(tm)(inp, tgt, n).numpy(), want, atol=LP_ATOL)

    cfg_kw = dict(nn_hidden=24, nn_layers=2, lr=5e-3, num_nn_steps=20)
    jstep = JNL.make_nnlm_train_step(jm, JTrainConfig(**cfg_kw))
    from mogasr.am.train_nn import make_optimizer as j_opt

    jstate = JNL.NnlmTrainState(jp, j_opt(JTrainConfig(**cfg_kw)).init(jp), jnp.zeros((), jnp.int32))
    cfg = TrainConfig(**cfg_kw)
    tm = copy.deepcopy(tm)  # the fixture's model keeps the reference's initial weights
    state = NL.init_nnlm_train_state(tm, cfg)
    step = NL.make_nnlm_train_step(tm, cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        pick = rng.integers(0, len(SEQS), size=4)
        b = NL.lm_batch([SEQS[j] for j in pick], vocab, 7)
        jstate, jm_ = jstep(jstate, *(jnp.asarray(a) for a in b))
        state, m = step(state, *b)
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-5)
    for k, v in from_flax(tm, jstate.params).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


def test_perplexity_rescoring_and_checkpoint(lms, tmp_path):
    """Held-out perplexity and the N-best re-ranking (the reference's order,
    ties in input order; its combined scores to 1e-5), then save/load."""
    arch, jm, jp, tm = lms
    vocab = NL.LmVocab(TOKENS)
    held = [["a", "b"], ["c", "zz", "d"], ["e"]]
    np.testing.assert_allclose(NL.nnlm_perplexity(tm, vocab, held),
                               JNL.nnlm_perplexity(jm, jp, JNL.LmVocab(TOKENS), held), rtol=1e-5)
    nbest = [[(["a", "b"], -3.0), (["a", "c"], -3.5), (["b"], -3.0)], [], [(["d", "d", "e"], -1.0),
                                                                          (["d", "d", "e"], -1.0)]]
    want = JNL.rescore_nbest_nnlm(jm, jp, JNL.LmVocab(TOKENS), nbest, weight=0.7)
    got = NL.rescore_nbest_nnlm(tm, vocab, nbest, weight=0.7)
    assert [[w for w, _s in lst] for lst in got] == [[w for w, _s in lst] for lst in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _w, s in g], [s for _w, s in w], atol=LP_ATOL)
    NL.save_nnlm(str(tmp_path / "nnlm"), tm, vocab)
    with open(tmp_path / "nnlm" / "nnlm.json") as f:
        assert json.load(f) == {"tokens": list(TOKENS), "arch": arch, "embed": tm.embed, "hidden": 24, "layers": 2}
    back, vocab2 = NL.load_nnlm(str(tmp_path / "nnlm"), torch.device("cpu"))
    assert vocab2 == vocab and type(back) is type(tm)
    inp, tgt, n = NL.lm_batch(SEQS, vocab, 7)
    assert torch.equal(NL.make_nnlm_scorer(back)(inp, tgt, n), NL.make_nnlm_scorer(tm)(inp, tgt, n))


def test_train_lm_twin_matches_train_nnlm(tmp_path):
    """``cli.train_lm`` (the default, neural path): its checkpoint equals
    ``train_nnlm`` on the same split and sizes, and its record has the
    held-out perplexity of that model."""
    from mogasr_torch.cli import train_lm
    from mogasr_torch.data.synthetic import make_corpus

    run = str(tmp_path / "lm")
    train_lm.main(["--synthetic", "20", "--steps", "4", "--hidden", "16", "--batch-size", "8", "--device", "cpu",
                   "--run-dir", run])
    transcripts = [[w.lower() for w in u.words] for u in make_corpus(20, seed=0)]
    train, held = transcripts[:-2], transcripts[-2:]
    vocab = NL.vocab_from_transcripts(train)
    model, sd = NL.train_nnlm(train, vocab, TrainConfig(nn_hidden=16, nn_layers=1, lr=5e-3, num_nn_steps=4),
                              batch_size=8, device=torch.device("cpu"))
    back, vocab2 = NL.load_nnlm(os.path.join(run, "nnlm"), torch.device("cpu"))
    assert vocab2 == vocab
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f][-1]
    assert rec["stage"] == "train_nnlm_done" and rec["vocab"] == vocab.n_tokens
    assert rec["heldout_ppl"] == round(NL.nnlm_perplexity(model, vocab, held), 3)

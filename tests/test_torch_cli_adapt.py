"""The adaptation pipeline of the port (``pipeline.decode_with_{fmllr,mllr,
vtln}``, ``train_sat``, ``estimate_stc_batches``, ``train_lda_mllt``) and
its CLI twins (``eval --fmllr/--mllr/--vtln``, ``train_gmm --lda``) against
the JAX package and the reference CLIs, on the CPU.

One corpus for all: the reference CLIs' ``--synthetic 8 --synthetic-seed
3``, featurized by the JAX front end in the CLIs' batches of 16 (the port's
FeatBatches hold the same arrays), so the reference's jitted functions
compile once for the pipeline tests and the CLI runs; a K = 2 GMM trained on
it by the port. The pipeline functions get the same features on both sides:
two-pass transcripts and VTLN's warps identical, the transforms within
TRANSFORM_ATOL of JAX's (float32 statistics summed in another order), SAT's
and the LDA+MLLT recipe's histories within HISTORY_RTOL (carried through EM
steps), the LDA+MLLT transform within TRANSFORM_ATOL up to the sign of each
row (an eigenvector's sign is LAPACK's choice; a diagonal GMM does not see
it), decodes after STC and LDA+MLLT identical. The reference's behavioural
checks: SAT's history rises, the corrupted speaker's transform is far from
the identity and farther than the clean one's, SAT beats continuing plain
EM. The CLI twins are held to the pipeline functions above, which are
held to the reference's (a reference CLI's first run of one of these paths
compiles its JAX functions anew on its sharded 8-device mesh, several
times the cost of the pipeline tests): ``eval --fmllr``,
``--mllr`` and ``--vtln`` decode the pipeline function's hypotheses on the
same corpus and random GMM and resume as a whole sweep; ``train_gmm --lda``
writes the reference's record and its system in the port's checkpoint
format. The flags that stay refused name their ROADMAP item; the
two-pass flags with a hybrid ``--am`` stop as the reference's do."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.am.gmm import GmmSet as JaxGmmSet
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr.data.synthetic import make_corpus
from mogasr.hmm.lexicon import synthetic_lexicon as jax_synthetic_lexicon
from mogasr.hmm.topology import build_topology as jax_build_topology
from mogasr_torch import config as tc
from mogasr_torch import pipeline as pipe
from mogasr_torch.cli import decode as cli_decode
from mogasr_torch.cli import eval as cli_eval
from mogasr_torch.cli import train_gmm as cli_train_gmm
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.utils.checkpoint import restore_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread: the suite's workers share the cores,
    and a pool of them per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRANSFORM_ATOL = 1e-3  # chip_smoke.py phase 27 holds the card's transforms to the plain path's at the same
HISTORY_RTOL = 1e-4
CORPUS = ["--synthetic", "8", "--synthetic-seed", "3"]
# the eval CLIs' decode configuration (their --acoustic-scale and --insertion-penalty defaults)
DCFG, JDCFG = (tc.DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0),
               DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0))


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def system():
    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=16)  # the eval CLI's batches
    utts = [(u.utt_id, u.wave, u.words) for u in make_corpus(8, seed=3)]
    jbatches = jax_pipe.featurize(utts, fcfg, bcfg)
    lex, jlex = synthetic_lexicon(), jax_synthetic_lexicon()
    topo, jtopo = build_topology(lex, tc.TopologyConfig()), jax_build_topology(jlex, TopologyConfig())
    batches = [pipe.FeatBatch(fb.utt_ids, _t(fb.feats), _t(fb.n_frames), fb.words) for fb in jbatches]
    gcfg = tc.GmmConfig(n_states=topo.n_pdfs, n_components=2, feat_dim=fcfg.feat_dim)
    gmm, _ = pipe.train_gmm(batches, lex, topo, gcfg, tc.TrainConfig(num_em_iters=4))
    jgmm = JaxGmmSet(*(jnp.asarray(a.numpy()) for a in gmm))
    return dict(utts=utts, batches=batches, jbatches=jbatches, lex=lex, jlex=jlex, topo=topo, jtopo=jtopo,
                gmm=gmm, jgmm=jgmm, fcfg=fcfg, bcfg=bcfg, gcfg=gcfg)


def _two_speakers(s, A, b):
    """Ids spkA-/spkB- alternating; speaker B's features through x A^T + b;
    the same arrays for both packages."""
    out, jout = [], []
    for fb, jfb in zip(s["batches"], s["jbatches"]):
        ids = [f"spk{'B' if i % 2 else 'A'}-{u}" for i, u in enumerate(fb.utt_ids)]
        feats = fb.feats.numpy().copy()
        for bi, uid in enumerate(ids):
            if uid.startswith("spkB"):
                feats[bi] = feats[bi] @ A.T + b
        out.append(pipe.FeatBatch(ids, _t(feats), fb.n_frames, fb.words))
        jout.append(jax_pipe.FeatBatch(ids, jnp.asarray(feats), jfb.n_frames, jfb.words))
    return out, jout


def _corruption(seed, scale, D):
    rng = np.random.default_rng(seed)
    rng.standard_normal(D)  # tests/test_fmllr.py's burnt draw
    return (np.eye(D) * scale).astype(np.float32), (0.5 * rng.standard_normal(D)).astype(np.float32)


def _close_transforms(Ws, jWs):
    assert set(Ws) == set(jWs)
    for spk in Ws:
        np.testing.assert_allclose(Ws[spk], jWs[spk], atol=TRANSFORM_ATOL, err_msg=spk)


def test_two_pass_fmllr_and_mllr_match_jax(system):
    """Speaker B corrupted (tests/test_fmllr.py's A = 0.8 I, b): pass-2
    transcripts identical and per-speaker transforms close, for fMLLR and
    for MLLR; the report's pass-1 alignment covers every frame."""
    s = system
    bs, jbs = _two_speakers(s, *_corruption(9, 0.8, s["fcfg"].feat_dim))
    report = {}
    hyps, Ws = pipe.decode_with_fmllr(bs, s["gmm"], s["lex"], s["topo"], DCFG, report=report)
    jhyps, jWs = jax_pipe.decode_with_fmllr(jbs, s["jgmm"], s["jlex"], s["jtopo"], JDCFG)
    assert hyps == jhyps and set(Ws) == {"spkA", "spkB"}
    _close_transforms(Ws, jWs)
    assert set(report["hyps1"]) == set(hyps) and set(report["seconds"]) == {"pass1", "align", "estimate", "pass2"}
    assert all(len(report["labels1"][u]) == int(n) for fb in bs for u, n in zip(fb.utt_ids, fb.n_frames))
    # a SAT-space model: pass 1 and the alignment run on si_gmm (the same
    # model here, so the result is the plain call's), the rest on gmm
    hyps_si, Ws_si = pipe.decode_with_fmllr(bs, s["gmm"], s["lex"], s["topo"], DCFG, si_gmm=s["gmm"])
    assert hyps_si == hyps and all(np.array_equal(Ws_si[k], Ws[k]) for k in Ws)
    hyps, Ws = pipe.decode_with_mllr(bs, s["gmm"], s["lex"], s["topo"], DCFG)
    jhyps, jWs = jax_pipe.decode_with_mllr(jbs, s["jgmm"], s["jlex"], s["jtopo"], JDCFG)
    assert hyps == jhyps
    _close_transforms(Ws, jWs)


def test_two_pass_vtln_matches_jax(system):
    """A speaker synthesized with formants scaled x1.12 (tests/test_vtln.py):
    both packages pick the same warp off 1.0 and decode the same
    transcripts; three warps keep the JAX front end's compiles few."""
    s = system
    utts = [(u.utt_id, u.wave, u.words) for u in make_corpus(4, words_per_utt=(2, 3), seed=77, formant_scale=1.12)]
    warps = (0.92, 1.0, 1.08)
    report = {}
    hyps, best = pipe.decode_with_vtln(utts, s["gmm"], s["lex"], s["topo"], tc.FrontendConfig(),
                                       tc.BatchConfig(batch_size=16), DCFG, warps=warps, report=report)
    jhyps, jbest = jax_pipe.decode_with_vtln(utts, s["jgmm"], s["jlex"], s["jtopo"], s["fcfg"], s["bcfg"], JDCFG,
                                             warps=warps)
    assert best == jbest and len(best) == 1 and set(best.values()) != {1.0}, (best, jbest)
    assert hyps == jhyps and set(report["loglik"]["synth"]) == set(warps)


def _decode(mod, batches, gmm, lex, topo, dcfg):
    graph = mod.word_decode_graph(lex, topo, dcfg)
    return [out for fb in batches for out in mod.decode_batch(fb, mod.score_batch(fb.feats, gmm), graph, dcfg)]


def test_estimate_stc_batches_matches_jax(system):
    s = system
    A, vars_y, gmm_y, tf = pipe.estimate_stc_batches(s["batches"], s["gmm"], s["lex"], s["topo"], n_iters=4)
    jA, jvars_y, jgmm_y, jtf = jax_pipe.estimate_stc_batches(s["jbatches"], s["jgmm"], s["jlex"], s["jtopo"],
                                                             n_iters=4)
    np.testing.assert_allclose(A, jA, atol=TRANSFORM_ATOL)
    np.testing.assert_allclose(vars_y, jvars_y, rtol=1e-3)
    assert _decode(pipe, tf(s["batches"]), gmm_y, s["lex"], s["topo"], DCFG) == \
        _decode(jax_pipe, jtf(s["jbatches"]), jgmm_y, s["jlex"], s["jtopo"], JDCFG)


def test_train_sat_matches_jax(system):
    """Speaker B corrupted with tests/test_sat.py's A = 0.75 I, b."""
    s = system
    D = s["fcfg"].feat_dim
    b = (0.6 * np.random.default_rng(5).standard_normal(D)).astype(np.float32)
    bs, jbs = _two_speakers(s, (np.eye(D) * 0.75).astype(np.float32), b)
    gcfg = s["gcfg"]
    gmm_si, _ = pipe.train_gmm(bs, s["lex"], s["topo"], gcfg, tc.TrainConfig(num_em_iters=4))
    jgmm_si = JaxGmmSet(*(jnp.asarray(a.numpy()) for a in gmm_si))
    gmm_sat, Ws, hist = pipe.train_sat(bs, s["lex"], s["topo"], gcfg, gmm_si, n_iters=2)
    jgmm_sat, jWs, jhist = jax_pipe.train_sat(jbs, s["jlex"], s["jtopo"],
                                              GmmConfig(n_states=gcfg.n_states, n_components=2, feat_dim=D),
                                              jgmm_si, n_iters=2)
    np.testing.assert_allclose(hist, jhist, rtol=HISTORY_RTOL)
    assert set(Ws) == {"spkA", "spkB"}
    _close_transforms(Ws, jWs)
    np.testing.assert_allclose(gmm_sat.means.numpy(), np.asarray(jgmm_sat.means), atol=TRANSFORM_ATOL)
    eye = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    dev = {spk: float(np.abs(W - eye).max()) for spk, W in Ws.items()}
    assert hist[-1] > hist[0] and dev["spkB"] > 0.2 and dev["spkB"] > dev["spkA"], (hist, dev)
    _gmm, hist_plain = pipe.train_gmm(bs, s["lex"], s["topo"], gcfg, tc.TrainConfig(num_em_iters=2), gmm=gmm_si)
    assert hist[-1] > hist_plain[-1], (hist, hist_plain)


def _align_rows(W, ref):
    """W with each row's sign flipped to agree with ref's."""
    signs = np.sign(np.sum(W * ref, axis=1, keepdims=True))
    return W * np.where(signs == 0, 1.0, signs)


def test_train_lda_mllt_matches_jax(system):
    """Context 1, 20 dims, 3 EM iterations and 2 MLLT iterations, booted
    from the fixture's GMM: the reference's recipe on both packages."""
    s = system
    kw = dict(context=1, lda_dim=20, mllt_iters=2)
    sys_t = pipe.train_lda_mllt(s["utts"], s["lex"], s["topo"], tc.FrontendConfig(), tc.BatchConfig(batch_size=16),
                                dataclasses.replace(s["gcfg"], feat_dim=20), tc.TrainConfig(num_em_iters=3),
                                s["gmm"], **kw)
    sys_j = jax_pipe.train_lda_mllt(s["utts"], s["jlex"], s["jtopo"], s["fcfg"], s["bcfg"],
                                    GmmConfig(n_states=s["topo"].n_pdfs, n_components=2, feat_dim=20),
                                    TrainConfig(num_em_iters=3), s["jgmm"], **kw)
    assert sys_t.transform.shape == sys_j.transform.shape == (20, 3 * s["fcfg"].base_dim + 1)
    np.testing.assert_allclose(_align_rows(sys_t.transform, sys_j.transform), sys_j.transform, atol=TRANSFORM_ATOL)
    np.testing.assert_allclose(sys_t.history, sys_j.history, rtol=HISTORY_RTOL)
    assert sys_t.history[-1] > sys_t.history[0]
    feats_t = sys_t.featurize(s["utts"], tc.BatchConfig(batch_size=16))
    assert _decode(pipe, feats_t, sys_t.gmm, s["lex"], s["topo"], DCFG) == \
        _decode(jax_pipe, sys_j.featurize(s["utts"], s["bcfg"]), sys_j.gmm, s["jlex"], s["jtopo"], JDCFG)


# ------------------------------------------------------------------ CLI twins


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _cli_corpus_and_gmm():
    """The twins' corpus, lexicon, topology and random GMM, as ``CORPUS
    --num-components 2`` make them."""
    import argparse

    from mogasr_torch.cli.common import load_corpus, load_or_random_gmm

    corpus, lex = load_corpus(cli_eval.parse_args(CORPUS))
    topo = build_topology(lex, tc.TopologyConfig())
    gmm = load_or_random_gmm(argparse.Namespace(gmm_ckpt=None, num_states=topo.n_pdfs, num_components=2), 39,
                             torch.device("cpu"))
    return corpus, lex, topo, gmm


@pytest.mark.parametrize("flag", ["--fmllr", "--mllr", "--vtln"])
def test_eval_two_pass_cli_is_the_pipeline(tmp_path, flag):
    """The twin's hypotheses are the pipeline function's on the same corpus
    and random GMM; the sweep is resumed as a whole."""
    argv = CORPUS + ["--num-components", "2", flag, "--run-dir", str(tmp_path), "--device", "cpu"]
    cli_eval.main(argv)
    got = _jsonl(str(tmp_path / "eval_hyps.jsonl"))
    corpus, lex, topo, gmm = _cli_corpus_and_gmm()
    bcfg = tc.BatchConfig(batch_size=16)
    if flag == "--vtln":
        want, per_spk = pipe.decode_with_vtln(corpus, gmm, lex, topo, tc.FrontendConfig(), bcfg, DCFG)
    else:
        two_pass = pipe.decode_with_fmllr if flag == "--fmllr" else pipe.decode_with_mllr
        want, per_spk = two_pass(pipe.featurize(corpus, tc.FrontendConfig(), bcfg, torch.device("cpu")), gmm, lex,
                                 topo, DCFG)
    assert {r["utt_id"]: r["hyp"] for r in got} == want and len(got) == 8 and set(per_spk) == {"synth"}
    assert sorted(r["utt_id"] for r in got) == sorted(u for u, _w, _words in corpus)
    rec = _records(str(tmp_path))[-1]
    assert (rec["stage"], rec["utts"]) == ("eval", 8)
    # started again with every utterance there: the two passes are skipped
    cli_eval.main(argv)
    assert _jsonl(str(tmp_path / "eval_hyps.jsonl")) == got
    again = _records(str(tmp_path))[-1]
    keys = ("utts", "wer", "sub", "dels", "ins")
    assert {k: again[k] for k in keys} == {k: rec[k] for k in keys}


def test_train_gmm_lda_cli(tmp_path):
    """The reference CLI's first run compiles its EM and LDA passes anew;
    the twin's record and checkpoint are ``train_lda_mllt``'s (held to the
    reference by ``test_train_lda_mllt_matches_jax``) in the reference's
    shape and the port's checkpoint format."""
    cli_train_gmm.main(CORPUS + ["--num-components", "2", "--num-iters", "3", "--lda", "1", "--lda-dim", "20",
                                 "--run-dir", str(tmp_path), "--device", "cpu"])
    rec = [r for r in _records(str(tmp_path)) if r["stage"] == "train_lda_mllt_done"]
    assert len(rec) == 1 and (rec[0]["context"], rec[0]["lda_dim"]) == (1, 20)
    assert set(rec[0]) == {"stage", "context", "lda_dim", "final_avg_loglik", "wall_sec", "time"}
    ck = restore_checkpoint(str(tmp_path / "gmm_lda"))
    assert ck["lda_transform"].shape == (20, 3 * 13 + 1) and ck["lda_context"].tolist() == [1]
    assert ck["means"].shape[-1] == 20 and np.isfinite(ck["means"]).all() and np.isfinite(ck["lda_transform"]).all()
    assert np.isfinite(rec[0]["final_avg_loglik"])


def test_refused_and_stopped_flags(tmp_path):
    with pytest.raises(SystemExit, match="--ivector-ckpt augments hybrid/CTC neural features"):
        cli_decode.main(["--synthetic", "1", "--ivector-ckpt", "iv", "--device", "cpu", "--run-dir",
                         str(tmp_path / "d")])
    with pytest.raises(SystemExit, match="GMM adaptation: incompatible with a hybrid --am"):
        cli_eval.main(CORPUS + ["--fmllr", "--am", "lstm", "--device", "cpu", "--run-dir", str(tmp_path / "e")])
    with pytest.raises(SystemExit, match="lexicon-free decoding"):
        cli_eval.main(CORPUS + ["--vtln", "--ctc", "--device", "cpu", "--run-dir", str(tmp_path / "f")])

"""The port's copies of the reference's numpy-only modules (config, hmm/,
data/{batching,synthetic}, eval/{wer,diarization}, frontend/numpy_ref,
lm/{ngram,arpa,unit_ngram}, decoder/{lattice,confusion,kws,biasing}, data/bpe) against the originals:
the same configs, graph arrays, batches, waves, WER counts, DER dicts,
features, LM tables, ARPA files, lattices, N-best lists, confusion networks
and keyword hits, bit for bit; the sources in COPIED are the originals but
for their imports."""

import dataclasses
import os

import numpy as np
import pytest

import mogasr.config as jax_config
from mogasr.data import batching as jax_batching
from mogasr.data import synthetic as jax_syn
from mogasr.decoder import confusion as jax_cn
from mogasr.decoder import kws as jax_kws
from mogasr.decoder import lattice as jax_lat
from mogasr.eval import diarization as jax_diarization
from mogasr.eval import wer as jax_wer
from mogasr.frontend import numpy_ref as jax_numpy_ref
from mogasr.hmm import graph as jax_gr
from mogasr.hmm import triphone as jax_tri
from mogasr.lm import arpa as jax_arpa
from mogasr.lm import ngram as jax_ngram
from mogasr.utils.bundle import load_system as jax_load_system
from mogasr_torch import config
from mogasr_torch.data import batching
from mogasr_torch.data import synthetic as syn
from mogasr_torch.decoder import confusion as cn
from mogasr_torch.decoder import kws
from mogasr_torch.decoder import lattice as lat_mod
from mogasr_torch.eval import diarization
from mogasr_torch.eval import wer
from mogasr_torch.frontend import numpy_ref
from mogasr_torch.hmm import graph as gr
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.lm import arpa
from mogasr_torch.lm import ngram
from mogasr_torch.utils.bundle import load_system

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "headline")


@pytest.fixture(scope="module")
def headline():
    import torch

    ours = load_system(BUNDLE, torch.device("cpu"))
    theirs = jax_load_system(BUNDLE)
    return ours, theirs


@pytest.fixture(scope="module")
def held_out():
    """The first 4 held-out utterances of bench.py, from both packages."""
    def corpus(s):
        return s.make_corpus_v2(4, lexicon=s.extended_lexicon(300), speakers=s.make_speakers(20),
                                style=s.CorpusStyle(), seed=999, words_per_utt=(3, 9))
    return corpus(syn), corpus(jax_syn)


def _assert_same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["FrontendConfig", "BatchConfig", "DecodeConfig", "GmmConfig",
                                  "TopologyConfig", "TrainConfig"])
def test_configs_match(name):
    assert dataclasses.asdict(getattr(config, name)()) == dataclasses.asdict(getattr(jax_config, name)())


def test_word_loop_graph_matches(headline):
    (_, _, _, tied, _), (_, _, _, jtied, _) = headline
    g = tri.word_loop_graph_cd(tied, insertion_penalty=2.0)
    jg = jax_tri.word_loop_graph_cd(jtied, insertion_penalty=2.0)
    assert g.n_states == 3048 and g.labels == jg.labels
    _assert_same_arrays(gr.batch_graphs([g] * 3), jax_gr.batch_graphs([jg] * 3))


def test_cd_align_graphs_match(headline, held_out):
    (_, topo, _, tied, _), (_, jtopo, _, jtied, _) = headline
    utts, _ = held_out
    gs = [tri.align_graph_cd(tied, topo.lexicon.words_to_phone_ids(u.words, oov="sil")) for u in utts]
    jgs = [jax_tri.align_graph_cd(jtied, jtopo.lexicon.words_to_phone_ids(u.words, oov="sil")) for u in utts]
    _assert_same_arrays(gr.batch_graphs(gs, j_max=192), jax_gr.batch_graphs(jgs, j_max=192))
    _assert_same_arrays(gr.batch_graphs([gr.align_graph(topo, [0, 3, 1])]),
                        jax_gr.batch_graphs([jax_gr.align_graph(jtopo, [0, 3, 1])]))


def test_synthetic_waves_match(held_out):
    utts, jutts = held_out
    for u, ju in zip(utts, jutts):
        assert (u.utt_id, u.words) == (ju.utt_id, ju.words)
        np.testing.assert_array_equal(u.wave, ju.wave)


def test_make_batches_matches(held_out):
    utts, _ = held_out
    items = [(u.utt_id, u.wave, u.words) for u in utts]
    fcfg = config.FrontendConfig()
    ours = list(batching.make_batches(items, config.BatchConfig(batch_size=3, bucket_boundaries=(250, 450, 600)),
                                      fcfg))
    theirs = list(jax_batching.make_batches(
        items, jax_config.BatchConfig(batch_size=3, bucket_boundaries=(250, 450, 600)), jax_config.FrontendConfig()))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert (a.utt_ids, a.words) == (b.utt_ids, b.words)
        np.testing.assert_array_equal(a.waves, b.waves)
        np.testing.assert_array_equal(a.num_samples, b.num_samples)


def test_wer_counts_match():
    rng = np.random.default_rng(0)
    vocab = ["a", "b", "c", "d", "e"]
    refs = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    hyps = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    for native in (True, False):  # the reference's C++ scorer, where built, and its Python DP
        w, counts = wer.corpus_wer(refs, hyps)
        jw, jcounts = jax_wer.corpus_wer(refs, hyps, native=native)
        assert w == jw and dataclasses.astuple(counts) == dataclasses.astuple(jcounts)
    assert wer.per_utt_wer(refs, hyps) == jax_wer.per_utt_wer(refs, hyps)
    assert wer.wer_bootstrap_ci(refs, hyps, n_boot=50) == jax_wer.wer_bootstrap_ci(refs, hyps, n_boot=50)
    assert wer.error_report(refs[:5], hyps[:5]) == jax_wer.error_report(refs[:5], hyps[:5])


def test_numpy_ref_features_match(held_out):
    utts, _ = held_out
    for cfg, jcfg in ((config.FrontendConfig(), jax_config.FrontendConfig()),
                      (config.FrontendConfig(cmvn="sliding"), jax_config.FrontendConfig(cmvn="sliding"))):
        for u in utts[:2]:
            np.testing.assert_array_equal(numpy_ref.extract_features_np(u.wave, cfg),
                                          jax_numpy_ref.extract_features_np(u.wave, jcfg))


# ------------------------------------------- the LM and lattice toolchain

COPIED = ["lm/ngram.py", "lm/arpa.py", "decoder/lattice.py", "decoder/confusion.py", "decoder/kws.py",
          "data/kaldi_io.py", "data/audio.py", "data/flac_write.py", "data/manifest.py", "data/librispeech.py",
          "data/augment.py", "native/flac_native.cpp", "frontend/vad.py", "frontend/endpoint.py",
          "frontend/pitch_stream.py", "eval/diarization.py", "data/bpe.py", "lm/unit_ngram.py",
          "decoder/biasing.py", "native/ctc_beam_native.cpp"]
TOKENS = ["a", "b", "c", "<sil>"]
TEXTS = [["a", "b"], ["a", "b", "c"], ["c"], ["b", "a", "a"], ["a", "<sil>", "b"]]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_sources_match_originals(rel):
    """Each copy is its original with the imports pointed at the port and one
    line saying so, nothing else; the C++ source is byte for byte its
    original."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "mogasr", rel), "rb") as f:
        original = f.read().decode()
    with open(os.path.join(repo, "mogasr_torch", rel), "rb") as f:
        copy = f.read().decode()
    if rel.endswith(".cpp"):
        assert copy == original
        return
    note = f"The port's copy of mogasr/{rel}, its imports pointed at mogasr_torch.\n"
    assert copy.count(note) == 1
    copy = copy.replace("\n" + note, "").replace("mogasr_torch.", "mogasr.")
    # the copies name no directory of the machine the reference was written on
    assert copy == original.replace("/root/reference", "reference")


def _lms(pkg):
    return {
        "bigram": pkg.estimate_bigram(TEXTS, TOKENS),
        "bigram_kn": pkg.estimate_bigram_kn(TEXTS, TOKENS),
        "trigram": pkg.estimate_trigram(TEXTS, TOKENS),
        "trigram_kn": pkg.estimate_trigram_kn(TEXTS, TOKENS),
        "grammar": pkg.grammar_bigram([["a", "b"], ["c", "a"]], tokens=TOKENS),
        "uniform": pkg.uniform_bigram(TOKENS),
    }


def _lm_arrays(lm):
    return {k: v for k, v in vars(lm).items() if isinstance(v, np.ndarray)}


def _random_lattices(L, n=3, seed=0):
    """Small lattices of the given package: every span of 1-3 frames holds an
    arc of 2-3 random chains (the 4 tokens), random scores."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n):
        frames = 7 + 2 * u
        arcs = []
        for end in range(frames):
            for start in range(max(0, end - 2), end + 1):
                for c in rng.choice(len(TOKENS), size=int(rng.integers(2, 4)), replace=False):
                    arcs.append(L.Arc(start, end, int(c), TOKENS[int(c)], float(rng.normal(-3.0, 1.5))))
        out.append(L.Lattice(frames, arcs))
    return out


def test_ngram_copy_matches():
    ours, theirs = _lms(ngram), _lms(jax_ngram)
    for name in ours:
        _assert_same_arrays(_lm_arrays(ours[name]), _lm_arrays(theirs[name]))
        assert ours[name].tokens == theirs[name].tokens
        for words in (["a", "b"], ["c", "c", "<sil>"], []):
            assert ngram.sequence_logp(ours[name], words) == jax_ngram.sequence_logp(theirs[name], words)
        start, step, final = ngram.lm_stepper(ours[name])
        jstart, jstep, jfinal = jax_ngram.lm_stepper(theirs[name])
        assert start() == jstart() and step(start(), 1) == jstep(jstart(), 1)


def test_arpa_copy_matches(tmp_path):
    ours, theirs = _lms(ngram), _lms(jax_ngram)
    for name in ("bigram", "trigram_kn"):
        a, b = str(tmp_path / f"{name}_ours.arpa"), str(tmp_path / f"{name}_theirs.arpa")
        arpa.write_arpa(a, ours[name])
        jax_arpa.write_arpa(b, theirs[name])
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
        _assert_same_arrays(_lm_arrays(arpa.read_arpa_trigram(a, tokens=TOKENS)),
                            _lm_arrays(jax_arpa.read_arpa_trigram(b, tokens=TOKENS)))


@pytest.mark.parametrize("lm_name", ["bigram", "trigram_kn"])
def test_lattice_confusion_kws_copies_match(tmp_path, lm_name):
    lm, jlm = _lms(ngram)[lm_name], _lms(jax_ngram)[lm_name]
    lats, jlats = _random_lattices(lat_mod), _random_lattices(jax_lat)
    terms = [["a"], ["a", "b"], ["c"]]
    for lat, jl in zip(lats, jlats):
        assert lat_mod.lattice_nbest(lat, lm, 5) == jax_lat.lattice_nbest(jl, jlm, 5)
        assert lat_mod.rescore_lattice(lat, lm) == jax_lat.rescore_lattice(jl, jlm)
        assert lat_mod.lattice_oracle_errors(lat, ["a", "b"]) == jax_lat.lattice_oracle_errors(jl, ["a", "b"])
        arcs, post, z = cn.lattice_arc_posteriors(lat, lm)
        jarcs, jpost, jz = jax_cn.lattice_arc_posteriors(jl, jlm)
        assert [dataclasses.astuple(a) for a in arcs] == [dataclasses.astuple(a) for a in jarcs]
        np.testing.assert_array_equal(post, jpost)
        assert z == jz
        slots, jslots = cn.confusion_network(lat, lm), jax_cn.confusion_network(jl, jlm)
        assert [dataclasses.astuple(s) for s in slots] == [dataclasses.astuple(s) for s in jslots]
        assert cn.consensus_decode(slots) == jax_cn.consensus_decode(jslots)
        assert cn.mbr_nbest_decode(lat, lm, n=6) == jax_cn.mbr_nbest_decode(jl, jlm, n=6)
        assert [dataclasses.astuple(h) for h in kws.search_slots(slots, ["a", "b"], threshold=0.01)] == \
            [dataclasses.astuple(h) for h in jax_kws.search_slots(jslots, ["a", "b"], threshold=0.01)]
    hits = kws.keyword_search_batch(lats, lm, terms, threshold=0.01)
    jhits = jax_kws.keyword_search_batch(jlats, jlm, terms, threshold=0.01)
    assert [[dataclasses.astuple(h) for h in r] for r in hits] == [[dataclasses.astuple(h) for h in r] for r in jhits]
    assert any(hits)
    # lattices_from_pass on random pass arrays, and the archives
    rng = np.random.default_rng(1)
    sc = rng.normal(-5, 2, (2, 9, 4)).astype(np.float32)
    sc[0, 3, 1] = -1e30
    st = np.minimum(rng.integers(0, 9, (2, 9, 4)), np.arange(9)[None, :, None]).astype(np.int32)
    ba = rng.normal(-1, 1, (2, 9, 4)).astype(np.float32)
    nf = np.asarray([9, 5])
    for beam in (None, 2.0):
        a = lat_mod.lattices_from_pass(sc, st, ba, nf, TOKENS, prune_beam=beam)
        b = jax_lat.lattices_from_pass(sc, st, ba, nf, TOKENS, prune_beam=beam)
        assert [(x.n_frames, [dataclasses.astuple(r) for r in x.arcs]) for x in a] == \
            [(x.n_frames, [dataclasses.astuple(r) for r in x.arcs]) for x in b]
    path = str(tmp_path / "lats.txt")
    lat_mod.write_lattices(path, {f"u{i}": lat for i, lat in enumerate(lats)})
    assert {k: [dataclasses.astuple(r) for r in v.arcs] for k, v in jax_lat.read_lattices(path).items()} == \
        {f"u{i}": [dataclasses.astuple(r) for r in lat.arcs] for i, lat in enumerate(lats)}


def test_der_copy_matches():
    """``eval/diarization.der`` (the copy) against the original on random
    turn sets, with and without a collar: the same dict, bit for bit."""
    rng = np.random.default_rng(0)

    def turns(n, labels):
        edges = np.sort(rng.uniform(0.0, 30.0, 2 * n)).round(2)
        return [(float(a), float(b), labels[int(rng.integers(len(labels)))]) for a, b in edges.reshape(n, 2)]

    for _ in range(5):
        ref, hyp = turns(6, ["a", "b", "c"]), turns(8, [0, 1, 2, 3])
        for collar in (0.0, 0.25):
            assert diarization.der(ref, hyp, collar_s=collar) == jax_diarization.der(ref, hyp, collar_s=collar)
    assert diarization.der([], [(0.0, 1.0, 0)]) == jax_diarization.der([], [(0.0, 1.0, 0)])


def test_bpe_unit_lm_biasing_copies_match():
    """data/bpe, lm/unit_ngram and decoder/biasing: the same merges and
    encodings, the same unit-bigram tables and perplexity, the same biasing
    scores and compiled tables."""
    from mogasr.data import bpe as jax_bpe
    from mogasr.decoder import biasing as jax_biasing
    from mogasr.lm import unit_ngram as jax_unit_ngram
    from mogasr_torch.data import bpe
    from mogasr_torch.decoder import biasing
    from mogasr_torch.lm import unit_ngram

    texts = [u.words for u in syn.make_corpus(12, seed=3)]
    ours, theirs = bpe.train_bpe(texts, n_merges=15), jax_bpe.train_bpe(texts, n_merges=15)
    assert (ours.units, ours.merges) == (theirs.units, theirs.merges)
    seqs = [ours.encode(t) for t in texts]
    assert seqs == [theirs.encode(t) for t in texts] and [ours.decode(s) for s in seqs] == texts
    lm, jlm = unit_ngram.estimate_unit_bigram(seqs, ours.n_units), jax_unit_ngram.estimate_unit_bigram(
        seqs, ours.n_units)
    np.testing.assert_array_equal(lm.pair_logp, jlm.pair_logp)
    np.testing.assert_array_equal(lm.init_logp, jlm.init_logp)
    assert unit_ngram.unit_perplexity(lm, seqs[:3]) == jax_unit_ngram.unit_perplexity(jlm, seqs[:3])
    phrases = [texts[0][:2], [texts[1][0]]]
    b, jb = biasing.biaser_from_bpe(ours, phrases), jax_biasing.biaser_from_bpe(theirs, phrases)
    assert [b.score(tuple(s[:k]), u) for s in seqs[:4] for k in range(len(s)) for u in range(5)] == \
        [jb.score(tuple(s[:k]), u) for s in seqs[:4] for k in range(len(s)) for u in range(5)]
    c, jc = biasing.CompiledBiaser(b, ours.n_units), jax_biasing.CompiledBiaser(jb, ours.n_units)
    np.testing.assert_array_equal(c.delta, jc.delta)
    np.testing.assert_array_equal(c.next_state, jc.next_state)

"""The port's lattice path against the JAX package on the CPU: the lattice
pass (``pipeline.decode_batch_lattices``) on the same float32 scores, the
host algorithms on its lattices (trigram rescoring, N-best, confusion
networks, N-best MBR, keyword search, the lattice oracle), lattice archives
written by one package and read by the other, and the CLI twins
``mogasr_torch.cli.decode`` and ``mogasr_torch.cli.search`` against the
reference CLIs run in-process (the same hypotheses, WER record, N-best
lists, lattices and keyword hits), with the flags that are not ported yet.

The lattices are small: the small synthetic lexicon (31 chains) and short
utterances, and a ``prune_beam`` where a trigram searches them (its LM
contexts grow as the square of the vocabulary)."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mogasr import pipeline as jax_pipe
from mogasr.decoder import confusion as jax_cn
from mogasr.decoder import kws as jax_kws
from mogasr.decoder import lattice as jax_lat
from mogasr.lm import ngram as jax_ngram
from mogasr_torch import pipeline as pipe
from mogasr_torch.cli import decode as cli_decode
from mogasr_torch.cli import search as cli_search
from mogasr_torch.cli.common import load_or_random_gmm
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr_torch.data.synthetic import make_corpus
from mogasr_torch.decoder import confusion as cn
from mogasr_torch.decoder import kws
from mogasr_torch.decoder import lattice as lat_mod
from mogasr_torch.hmm.lexicon import synthetic_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.lm import ngram

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# arc scores: exit score minus entry base, both bitwise equal to the
# reference's; held to the limit the lattice pass's scores are held to
ARC_RTOL = 1e-4
PRUNE_BEAM = 6.0
# The CLIs featurize on their own front ends (the port's PyTorch one, the
# reference's JAX one: within 3e-4 of each other, tests/test_golden.py), so
# their scores, lattice arc scores and N-best log-probs differ in the last
# digits; words, spans and arcs are the same.
CLI_RTOL = 1e-5
# --synthetic-seed 34: its first utterance is the shortest two-word one of
# the small corpus's seeds (72 frames), so the trigram passes stay cheap
CLI_CORPUS = ["--synthetic", "1", "--synthetic-seed", "34"]
SEARCH_CORPUS = ["--synthetic", "1", "--synthetic-seed", "34"]
SEARCH_TERMS = "thin,way,bee day"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (see test_torch_cli)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def system():
    """Three short utterances of the small lexicon featurized once, scored by
    the decode CLIs' random GMM (float32, sum mode), the word loop, and each
    package's bigram and trigram over the transcripts."""
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    # no insertion penalty: with it this model's pruned lattices hold little but silence
    fcfg, dcfg = FrontendConfig(), DecodeConfig(word_insertion_penalty=0.0)
    utts = make_corpus(3, seed=34)
    fb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg,
                        BatchConfig(batch_size=4, bucket_boundaries=(400,)), CPU)[0]
    args = dataclasses.make_dataclass("A", ["gmm_ckpt", "num_states", "num_components"])(None, topo.n_pdfs, 8)
    scores = pipe.score_batch(fb.feats, load_or_random_gmm(args, fcfg.feat_dim, CPU))
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    toks = sorted(set(graph.labels))
    texts = [fb.words[b] for b in range(fb.size)] + [["thin", "way"], ["bee", "day", "thin"]]
    lms = {"bigram": (ngram.estimate_bigram(texts, toks), jax_ngram.estimate_bigram(texts, toks)),
           "trigram": (ngram.estimate_trigram(texts, toks), jax_ngram.estimate_trigram(texts, toks))}
    jfb = jax_pipe.FeatBatch(fb.utt_ids, jnp.asarray(fb.feats.numpy()), jnp.asarray(fb.n_frames.numpy()), fb.words)
    return fb, jfb, scores, graph, dcfg, lms


@pytest.fixture(scope="module")
def lattices(system):
    """Each package's pruned lattices of the same scores."""
    fb, jfb, scores, graph, dcfg, lms = system
    lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lms["bigram"][0], dcfg, prune_beam=PRUNE_BEAM)
    jlats, _ = jax_pipe.decode_batch_lattices(jfb, jnp.asarray(scores.numpy()), graph, lms["bigram"][1], dcfg,
                                              prune_beam=PRUNE_BEAM)
    return lats, jlats


def _assert_same_lattices(lats, jlats, rtol=ARC_RTOL):
    assert len(lats) == len(jlats)
    for lat, jl in zip(lats, jlats):
        assert lat.n_frames == jl.n_frames and len(lat.arcs) == len(jl.arcs) > 0
        assert [(a.start, a.end, a.chain, a.word) for a in lat.arcs] == \
            [(a.start, a.end, a.chain, a.word) for a in jl.arcs]
        np.testing.assert_allclose([a.score for a in lat.arcs], [a.score for a in jl.arcs], rtol=rtol)


@pytest.mark.parametrize("prune_beam", [None, PRUNE_BEAM])
def test_decode_batch_lattices_matches_jax(system, prune_beam):
    fb, jfb, scores, graph, dcfg, lms = system
    lats, res = pipe.decode_batch_lattices(fb, scores, graph, lms["bigram"][0], dcfg, prune_beam=prune_beam)
    jlats, jres = jax_pipe.decode_batch_lattices(jfb, jnp.asarray(scores.numpy()), graph, lms["bigram"][1], dcfg,
                                                 prune_beam=prune_beam)
    assert len(lats) == fb.size
    _assert_same_lattices(lats, jlats)
    np.testing.assert_array_equal(res.path.numpy(), np.asarray(jres.path))
    np.testing.assert_array_equal(res.entered.numpy(), np.asarray(jres.entered))
    np.testing.assert_allclose(res.score.numpy(), np.asarray(jres.score), rtol=ARC_RTOL)


def _host_call(name, mods, lat, lm, words):
    """One host algorithm of the lattice toolchain, from the given package's
    modules (lattice, confusion, kws), as plain comparable values."""
    L, C, K = mods
    if name == "rescore_lattice":
        return L.rescore_lattice(lat, lm)
    if name == "lattice_nbest":
        return L.lattice_nbest(lat, lm, 4)
    if name == "consensus_decode":
        slots = C.confusion_network(lat, lm)
        return [(s.start, s.end, s.words) for s in slots], C.consensus_decode(slots)
    if name == "mbr_nbest_decode":
        return C.mbr_nbest_decode(lat, lm, n=8)
    if name == "lattice_arc_posteriors":
        arcs, post, z = C.lattice_arc_posteriors(lat, lm)
        return [(a.start, a.end, a.chain) for a in arcs], list(post), z
    if name == "keyword_search":
        return [dataclasses.astuple(h) for h in K.keyword_search(lat, lm, [["thin"], ["bee", "day"], ["way"]],
                                                                 threshold=0.05)]
    if name == "lattice_oracle_errors":
        return L.lattice_oracle_errors(lat, words)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["rescore_lattice", "lattice_nbest", "consensus_decode", "mbr_nbest_decode",
                                  "lattice_arc_posteriors", "keyword_search", "lattice_oracle_errors"])
def test_lattice_host_algorithms_match_jax(system, lattices, name):
    """Each package's function on its own lattices, under its own trigram
    (keyword search under the bigram, as cli/search.py does)."""
    fb, _jfb, _scores, _graph, _dcfg, lms = system
    lats, jlats = lattices
    which = "bigram" if name == "keyword_search" else "trigram"
    lm, jlm = lms[which]
    outs = []
    for b, (lat, jl) in enumerate(zip(lats, jlats)):
        got = _host_call(name, (lat_mod, cn, kws), lat, lm, fb.words[b])
        want = _host_call(name, (jax_lat, jax_cn, jax_kws), jl, jlm, fb.words[b])
        _assert_close(got, want)
        outs.append(got)
    if name in ("lattice_nbest", "keyword_search"):  # the lattices hold alternatives and hits
        assert max(len(o) for o in outs) > 1 if name == "lattice_nbest" else any(outs)


def _assert_close(got, want):
    """Equal structure and strings, floats within ARC_RTOL."""
    if isinstance(got, float) or isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=ARC_RTOL, atol=1e-9)
    elif isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _assert_close(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_close(a, b)
    else:
        assert got == want


def test_lattice_archives_cross_read(tmp_path, lattices):
    lats, jlats = lattices
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "theirs.txt")
    lat_mod.write_lattices(ours, {f"u{b}": lat for b, lat in enumerate(lats)})
    jax_lat.write_lattices(theirs, {f"u{b}": lat for b, lat in enumerate(jlats)})
    for path in (ours, theirs):
        a, b = lat_mod.read_lattices(path), jax_lat.read_lattices(path)
        assert a.keys() == b.keys() == {"u0", "u1", "u2"}
        for k in a:
            assert a[k].n_frames == b[k].n_frames
            assert [dataclasses.astuple(x) for x in a[k].arcs] == [dataclasses.astuple(x) for x in b[k].arcs]
    # the port's own archive reads back exactly
    back = lat_mod.read_lattices(ours)
    assert all(back[f"u{b}"].arcs == lat.arcs for b, lat in enumerate(lats))


def _run_reference(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _decode_cli_both(tmp_path, monkeypatch, flags):
    """Run the port's decode CLI (on the CPU) and the reference's in-process
    with the same flags and ``--lattice-out``; check the WER record, the
    hypotheses and N-best lists and the lattice archive against each other."""
    from cli import decode as ref_decode

    out = {}
    for who in ("port", "reference"):
        d = tmp_path / who
        argv = CLI_CORPUS + flags + ["--run-dir", str(d / "run"), "--lattice-out", str(d / "lats.txt"),
                                     "--out", str(d / "hyps.jsonl")]
        if who == "port":
            cli_decode.main(argv + ["--device", "cpu"])
        else:
            _run_reference(ref_decode, argv, monkeypatch)
        out[who] = (_records(str(d / "run"))[-1], _jsonl(str(d / "hyps.jsonl")), str(d / "lats.txt"))
    (rec, hyps, lats), (jrec, jhyps, jlats) = out["port"], out["reference"]
    timing = ("wall_sec", "rtf", "utts_per_sec", "time")
    assert {k: v for k, v in rec.items() if k not in timing} == {k: v for k, v in jrec.items() if k not in timing}
    assert rec["stage"] == "decode" and rec["utts"] == 1 and "wer" in rec
    assert [(h["utt_id"], h["hyp"]) for h in hyps] == [(h["utt_id"], h["hyp"]) for h in jhyps]
    for h, jh in zip(hyps, jhyps):
        assert [n["hyp"] for n in h.get("nbest", [])] == [n["hyp"] for n in jh.get("nbest", [])]
        np.testing.assert_allclose([n["logp"] for n in h.get("nbest", [])],
                                   [n["logp"] for n in jh.get("nbest", [])], rtol=CLI_RTOL)
    a, b = lat_mod.read_lattices(lats), jax_lat.read_lattices(jlats)
    assert a.keys() == b.keys() and len(a) == 1
    _assert_same_lattices(list(a.values()), list(b.values()), rtol=CLI_RTOL)
    return hyps


def test_decode_cli_matches_reference(tmp_path, monkeypatch):
    """``--bigram-lm --trigram-rescore --lattice-out`` on the CPU: the
    reference CLI's hypotheses, WER record and lattice archive. The trigram
    passes over the CLI's unpruned lattice are the costly part (arcs x LM
    contexts on the host), so the N-best and consensus flags run with the
    bigram in the next test; the trigram's N-best and confusion networks are
    held to the reference's on pruned lattices in
    ``test_lattice_host_algorithms_match_jax``."""
    hyps = _decode_cli_both(tmp_path, monkeypatch, ["--bigram-lm", "--trigram-rescore"])
    assert all("nbest" not in h for h in hyps)


def test_decode_cli_nbest_consensus_matches_reference(tmp_path, monkeypatch):
    """``--bigram-lm --nbest 2 --consensus cn --lattice-out``: the consensus
    hypotheses and the N-best lists, both over the bigram."""
    hyps = _decode_cli_both(tmp_path, monkeypatch, ["--bigram-lm", "--nbest", "2", "--consensus", "cn"])
    assert all(len(h["nbest"]) == 2 for h in hyps)


def test_search_cli_matches_reference(tmp_path, monkeypatch):
    from cli import search as ref_search

    out = {}
    for who in ("port", "reference"):
        d = tmp_path / who
        argv = SEARCH_CORPUS + ["--terms", SEARCH_TERMS, "--threshold", "0.05", "--run-dir", str(d / "run"),
                                "--out", str(d / "hits.jsonl")]
        if who == "port":
            cli_search.main(argv + ["--device", "cpu"])
        else:
            _run_reference(ref_search, argv, monkeypatch)
        out[who] = (_records(str(d / "run"))[-1], _jsonl(str(d / "hits.jsonl")))
    (rec, hits), (jrec, jhits) = out["port"], out["reference"]
    assert (rec["stage"], rec["utts"], rec["terms"], rec["hits"]) == \
        (jrec["stage"], jrec["utts"], jrec["terms"], jrec["hits"])
    assert rec["hits"] > 0
    assert [(r["utt_id"], [(h["term"], h["start_sec"], h["end_sec"]) for h in r["hits"]]) for r in hits] == \
        [(r["utt_id"], [(h["term"], h["start_sec"], h["end_sec"]) for h in r["hits"]]) for r in jhits]
    np.testing.assert_allclose([h["posterior"] for r in hits for h in r["hits"]],
                               [h["posterior"] for r in jhits for h in r["hits"]], atol=1e-3)


# --ctc, --bias and --fusion-lm run since the CTC port
# (tests/test_torch_cli_ctc.py), --rnnt and --nnlm-rescore since the RNN-T
# port (tests/test_torch_cli_rnnt.py), --aed since the AED port
# (tests/test_torch_cli_aed.py); with --aed they stop where the reference's
# decode stops (its checks in its order: --ctc needs a neural --am, a lattice
# pass is no beam search, --aed without --bpe decodes phones, and the
# checkpoint comes last)
AED_STOPS = {"--ctc": "--ctc/--rnnt require a neural --am", "b.json": "--nn-ckpt is required",
             "--aed": "--aed without --bpe decodes phones", "lm": "--aed is direct beam-search decoding",
             "p.txt": "--aed without --bpe decodes phones", "u.npz": "--aed without --bpe decodes phones"}


@pytest.mark.parametrize("flags", [["--aed", "--ctc"], ["--aed", "--bpe", "b.json"], ["--aed"],
                                   ["--aed", "--nnlm-rescore", "lm"], ["--aed", "--bias", "p.txt"],
                                   ["--aed", "--fusion-lm", "u.npz"]])
def test_decode_cli_flags_not_ported_raise(tmp_path, flags):
    with pytest.raises(SystemExit, match=AED_STOPS[flags[-1]]):
        cli_decode.main(["--synthetic", "1"] + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])


def test_decode_cli_add_pitch(tmp_path):
    """``--add-pitch`` (ROADMAP item 10, refused until pitch.py was ported):
    the free decode runs on the features with the pitch triple."""
    cli_decode.main(["--synthetic", "1", "--add-pitch", "--num-components", "1", "--device", "cpu", "--run-dir",
                     str(tmp_path / "run"), "--out", str(tmp_path / "hyps.jsonl")])
    with open(tmp_path / "hyps.jsonl") as f:
        assert len(f.readlines()) == 1


# --rnnt-beam is read by decode --rnnt since the RNN-T port, --aed-beam and
# --aed-max-tokens by decode --aed since the AED port
@pytest.mark.parametrize("cli,flags", [(cli_decode, ["--aed-beam", "4"]), (cli_decode, ["--aed-max-tokens", "8"]),
                                       (cli_search, ["--terms", "cat", "--rnnt-beam", "4"])])
def test_cli_companion_flags_of_unported_paths_are_rejected(tmp_path, cli, flags, capsys, monkeypatch):
    """A path's companion options are never accepted and then ignored:
    search has no RNN-T path, so argparse refuses --rnnt-beam; decode --aed
    hands --aed-beam and --aed-max-tokens to its beam."""
    if cli is cli_decode:
        from test_torch_cli_aed import Probed, aed_probe

        seen = aed_probe(monkeypatch)
        with pytest.raises(Probed):
            cli.main(["--synthetic", "1", "--aed", "--mode", "phone", "--nn-ckpt", "x"] + flags
                     + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
        assert seen[flags[0][6:].replace("-", "_")] == int(flags[1])
        return
    with pytest.raises(SystemExit):
        cli.main(["--synthetic", "1"] + flags + ["--device", "cpu", "--run-dir", str(tmp_path / "run")])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_search_cli_ctc_not_ported_raises(tmp_path):
    """``search --ctc`` runs since the CTC port (tests/test_torch_cli_ctc.py
    holds it to the reference); without its checkpoint it stops as the
    reference stops."""
    with pytest.raises(SystemExit, match="--ctc requires --nn-ckpt"):
        cli_search.main(["--synthetic", "1", "--ctc", "--terms", "cat", "--device", "cpu", "--run-dir",
                         str(tmp_path / "run")])


def test_decode_clis_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_decode.main(["--synthetic", "1", "--run-dir", str(tmp_path / "run")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_search.main(["--synthetic", "1", "--terms", "cat", "--run-dir", str(tmp_path / "run")])

"""The port's data modules (copies of mogasr/data/{audio,flac_write,manifest,
librispeech,kaldi_io,augment}.py and of mogasr/native/flac_native.cpp, with
the port's own loader) against the reference's on the same files: WAV and
FLAC read bitwise alike, a JSONL manifest and a LibriSpeech-layout corpus load
alike through both ``load_corpus``, a Kaldi text archive written by either
package reads in the other, augmentation is equal from equal seeds, and the
FLAC decoder builds into build/mogasr_torch/, not next to its source. The
sources are held to the originals in test_torch_shared.py."""

import argparse
import os

import numpy as np
import pytest

from cli import common as ref_common
from mogasr.data import audio as jax_audio
from mogasr.data import augment as jax_augment
from mogasr.data import flac_write as jax_flac_write
from mogasr.data import kaldi_io as jax_kaldi_io
from mogasr.data import librispeech as jax_librispeech
from mogasr.data import manifest as jax_manifest
from mogasr_torch import native
from mogasr_torch.cli import common
from mogasr_torch.data import audio, augment, flac_write, kaldi_io, librispeech, manifest
from mogasr_torch.data.synthetic import LEXICON, make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_UTTS = 8


def write_lexicon(path, prons):
    with open(path, "w") as f:
        for word in sorted(prons):
            f.write(f"{word.upper()} {' '.join(prons[word])}\n")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """8 synthetic utterances (seed 21) written by the reference: a WAV
    manifest (ids and texts), the same as FLAC in LibriSpeech layout, a
    WAV LibriSpeech split, and the small lexicon."""
    d = tmp_path_factory.mktemp("corpus")
    utts = make_corpus(N_UTTS, words_per_utt=(2, 3), seed=21)
    os.makedirs(d / "wav")
    entries = []
    for u in utts:
        jax_audio.write_wav(str(d / "wav" / f"{u.utt_id}.wav"), u.wave, u.sample_rate)
        entries.append({"audio": f"wav/{u.utt_id}.wav", "text": " ".join(u.words), "id": u.utt_id})
    jax_manifest.write_manifest(str(d / "corpus.jsonl"), entries)
    jax_librispeech.write_fixture_corpus(str(d / "LibriSpeech"), "dev-clean", utts, fmt="flac")
    jax_librispeech.write_fixture_corpus(str(d / "LibriSpeech"), "test-clean", utts, fmt="wav")
    write_lexicon(str(d / "lexicon.txt"), LEXICON)
    return d, utts


def test_flac_decoder_builds_outside_the_source_tree():
    lib = native.load_flac_lib()
    assert lib is not None and native.load_flac_lib() is lib
    path = native.library_path("flac_native")
    assert os.path.isfile(path) and lib._name == path
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "mogasr_torch")
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native.__file__)))


def test_audio_reads_bitwise_alike(corpus_dir, tmp_path):
    d, utts = corpus_dir
    flacs = sorted((d / "LibriSpeech" / "dev-clean" / "0" / "0").glob("*.flac"))
    wavs = sorted((d / "wav").glob("*.wav"))
    assert len(flacs) == len(wavs) == N_UTTS
    for path in flacs + wavs:
        a, sr = audio.read_audio(str(path))
        b, jsr = jax_audio.read_audio(str(path))
        assert sr == jsr == 16000 and a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    # FLAC and WAV quantize alike: the same floats from both files
    for f, w in zip(flacs, wavs):
        assert np.array_equal(audio.read_audio(str(f))[0], audio.read_audio(str(w))[0])
    raw = flacs[0].read_bytes()
    got, want = audio.decode_flac_bytes(raw), jax_audio.decode_flac_bytes(raw)
    assert got[1:] == want[1:] and np.array_equal(got[0], want[0])
    # a stereo 24-bit FLAC written by the port's encoder, and resampling
    rng = np.random.default_rng(4)
    stereo = (rng.standard_normal((4000, 2)) * 0.2).clip(-1, 1).astype(np.float32)
    flac_write.write_flac(str(tmp_path / "s.flac"), stereo, 22050, bits=24)
    a, sr = audio.read_audio(str(tmp_path / "s.flac"))
    b, _ = jax_audio.read_audio(str(tmp_path / "s.flac"))
    assert sr == 16000 and np.array_equal(a, b)
    assert np.array_equal(audio.resample(stereo[:, 0], 22050, 8000), jax_audio.resample(stereo[:, 0], 22050, 8000))
    jax_flac_write.write_flac(str(tmp_path / "j.flac"), stereo, 22050, bits=24)
    assert (tmp_path / "s.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()


def _corpus_args(**kw):
    args = argparse.Namespace(synthetic=0, synthetic_v2=0, synthetic_seed=0, manifest=None, librispeech_root=None,
                              split="dev-clean", lexicon=None, max_utts=0)
    vars(args).update(kw)
    return args


@pytest.mark.parametrize("kind", ["manifest", "librispeech flac", "librispeech wav"])
def test_load_corpus_matches_reference(corpus_dir, kind):
    d, utts = corpus_dir
    if kind == "manifest":
        args = _corpus_args(manifest=str(d / "corpus.jsonl"), lexicon=str(d / "lexicon.txt"), max_utts=6)
    else:
        split = "dev-clean" if kind.endswith("flac") else "test-clean"
        args = _corpus_args(librispeech_root=str(d / "LibriSpeech"), split=split, lexicon=str(d / "lexicon.txt"))
    corpus, lex = common.load_corpus(args)
    jcorpus, jlex = ref_common.load_corpus(args)
    assert len(corpus) == (6 if kind == "manifest" else N_UTTS) == len(jcorpus)
    for (uid, w, words), (juid, jw, jwords) in zip(corpus, jcorpus):
        assert uid == juid and words == jwords and np.array_equal(w, jw)
    assert [words for _u, _w, words in corpus] == [u.words for u in utts[: len(corpus)]]
    assert (lex.phones, lex.words, lex.prons) == (jlex.phones, jlex.words, jlex.prons)
    with pytest.raises(SystemExit, match="--lexicon is required"):
        common.load_corpus(_corpus_args(**{k: v for k, v in vars(args).items() if k != "lexicon"}))


def test_manifest_errors_name_the_line(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"audio": "missing.wav", "text": "a"}\n')
    with pytest.raises(ValueError, match=r"bad.jsonl:1: cannot read"):
        manifest.read_manifest(str(path))
    path.write_text('\n{"text": "a"}\n')
    with pytest.raises(ValueError, match=r"bad.jsonl:2: need 'audio' and 'text'"):
        manifest.read_manifest(str(path))


def test_librispeech_index_matches_reference(corpus_dir):
    d, _utts = corpus_dir
    ls = librispeech.LibriSpeech(str(d / "LibriSpeech"), "dev-clean")
    jls = jax_librispeech.LibriSpeech(str(d / "LibriSpeech"), "dev-clean")
    assert ls.utt_ids() == jls.utt_ids() and len(ls) == N_UTTS
    wave, sr, text = ls.load_utterance(ls.utt_ids()[3])
    jwave, jsr, jtext = jls.load_utterance(ls.utt_ids()[3])
    assert (sr, text) == (jsr, jtext) and np.array_equal(wave, jwave)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_kaldi_ark_reads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(9)
    mats = [("u1", rng.standard_normal((5, 3)).astype(np.float32)), ("u2", np.zeros((0, 3), np.float32)),
            ("u3", rng.standard_normal((1, 39)).astype(np.float32))]
    path = str(tmp_path / "feats.ark")
    (kaldi_io if writer == "port" else jax_kaldi_io).write_ark_t(path, mats)
    back, jback = kaldi_io.read_ark_t_dict(path), jax_kaldi_io.read_ark_t_dict(path)
    assert list(back) == list(jback) == ["u1", "u2", "u3"]
    for k, m in mats:
        assert np.array_equal(back[k], jback[k]) and back[k].size == m.size  # an empty matrix reads as 0 x 0
        np.testing.assert_allclose(back[k].reshape(m.shape), m, rtol=1e-6)  # 7 significant digits in the text
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / "other.ark")
    (jax_kaldi_io if writer == "port" else kaldi_io).write_ark_t(other, mats)
    with open(other) as f:
        assert f.read() == text


@pytest.mark.parametrize("kw", [dict(speed_factors=(0.9, 1.0, 1.1)),
                                dict(speed_factors=(1.0,), snr_db_range=(5.0, 20.0), gain_db_range=(-6.0, 6.0))])
def test_augment_corpus_equal_from_equal_seeds(kw):
    utts = make_corpus(3, words_per_utt=(2, 2), seed=5)
    corpus = [(u.utt_id, u.wave, u.words) for u in utts]
    got = augment.augment_corpus(corpus, seed=3, **kw)
    want = jax_augment.augment_corpus(corpus, seed=3, **kw)
    assert [(u, ws) for u, _w, ws in got] == [(u, ws) for u, _w, ws in want]
    assert len(got) == len(corpus) * len(kw["speed_factors"])
    for (_u, w, _ws), (_ju, jw, _jws) in zip(got, want):
        assert w.dtype == jw.dtype and np.array_equal(w, jw)


def test_apply_augmentation_flags_match_reference():
    utts = make_corpus(2, words_per_utt=(2, 2), seed=6)
    corpus = [(u.utt_id, u.wave, u.words) for u in utts]
    args = argparse.Namespace(speed_perturb=True, aug_snr="10,20", aug_gain="-3,3", synthetic_seed=4)
    got, want = common.apply_augmentation(corpus, args), ref_common.apply_augmentation(corpus, args)
    assert [u for u, _w, _ws in got] == [u for u, _w, _ws in want] and len(got) == 6
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(got, want))
    off = argparse.Namespace(speed_perturb=False, aug_snr=None, aug_gain=None)
    assert common.apply_augmentation(corpus, off) is corpus

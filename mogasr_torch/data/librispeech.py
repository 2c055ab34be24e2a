"""LibriSpeech corpus reader.

The port's copy of mogasr/data/librispeech.py, its imports pointed at mogasr_torch.

SURVEY.md §1 L0: walks the standard LibriSpeech layout
(``root/split/speaker/chapter/{spk-chp-utt.flac, spk-chp.trans.txt}``),
yields utterance ids, waveforms and transcripts. Public interface:
``load_utterance(id) -> (waveform, sr, transcript)`` plus corpus iteration.

No LibriSpeech data (or flac codec) exists on the build box (SURVEY.md §0),
so this module is exercised against a fixture mini-corpus written in the same
layout with .wav files; the synthetic corpus (mogasr_torch.data.synthetic) backs
tests and benchmarks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.data.audio import read_audio


@dataclasses.dataclass
class UttMeta:
    utt_id: str
    audio_path: str
    transcript: str  # uppercase words, space separated (LibriSpeech style)

    @property
    def words(self) -> List[str]:
        return self.transcript.split()


class LibriSpeech:
    """Index of one LibriSpeech split (e.g. dev-clean, test-clean)."""

    AUDIO_EXTS = (".flac", ".wav")

    def __init__(self, root: str, split: str, target_sr: int = 16000):
        self.root = root
        self.split = split
        self.target_sr = target_sr
        self.utts: Dict[str, UttMeta] = {}
        self._index()

    def _index(self) -> None:
        split_dir = os.path.join(self.root, self.split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"no such split: {split_dir}")
        for dirpath, _dirnames, filenames in sorted(os.walk(split_dir)):
            trans = [f for f in filenames if f.endswith(".trans.txt")]
            audio = {
                os.path.splitext(f)[0]: os.path.join(dirpath, f)
                for f in filenames
                if f.endswith(self.AUDIO_EXTS)
            }
            for tf in trans:
                with open(os.path.join(dirpath, tf)) as fh:
                    for line in fh:
                        parts = line.strip().split(maxsplit=1)
                        if len(parts) != 2:
                            continue
                        utt_id, text = parts
                        if utt_id in audio:
                            self.utts[utt_id] = UttMeta(utt_id, audio[utt_id], text)

    def __len__(self) -> int:
        return len(self.utts)

    def utt_ids(self) -> List[str]:
        return sorted(self.utts)

    def load_utterance(self, utt_id: str) -> Tuple[np.ndarray, int, str]:
        """load_utterance(id) -> (waveform, sr, transcript) (SURVEY.md §1 L0)."""
        meta = self.utts[utt_id]
        wave, sr = read_audio(meta.audio_path, self.target_sr)
        return wave, sr, meta.transcript

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, str]]:
        for utt_id in self.utt_ids():
            wave, _sr, text = self.load_utterance(utt_id)
            yield utt_id, wave, text


def write_fixture_corpus(
    root: str,
    split: str,
    utts: Sequence,  # mogasr_torch.data.synthetic.Utterance
    fmt: str = "wav",
) -> None:
    """Write synthetic utterances in LibriSpeech layout for tests.

    ``fmt="flac"`` uses the in-repo codec (mogasr/data/flac_write.py), which
    is LibriSpeech's real on-disk format.
    """
    from mogasr_torch.data.audio import write_wav
    from mogasr_torch.data.flac_write import write_flac

    if fmt not in ("wav", "flac"):
        raise ValueError(f"unsupported fixture format {fmt!r}")
    spk, chp = "0", "0"
    d = os.path.join(root, split, spk, chp)
    os.makedirs(d, exist_ok=True)
    lines = []
    for i, u in enumerate(utts):
        utt_id = f"{spk}-{chp}-{i:04d}"
        path = os.path.join(d, f"{utt_id}.{fmt}")
        if fmt == "wav":
            write_wav(path, u.wave, u.sample_rate)
        else:
            write_flac(path, u.wave, u.sample_rate)
        lines.append(f"{utt_id} {' '.join(w.upper() for w in u.words)}")
    with open(os.path.join(d, f"{spk}-{chp}.trans.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

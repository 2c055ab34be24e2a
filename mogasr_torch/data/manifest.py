"""JSONL manifest corpus reader/writer (Lhotse/NeMo-style interchange).

The port's copy of mogasr/data/manifest.py, its imports pointed at mogasr_torch.

The modern corpus exchange format next to the LibriSpeech directory layout
(data/librispeech.py): one JSON object per line describing one utterance,

    {"audio": "rel/or/abs/path.{wav,flac}", "text": "hello world",
     "id": "utt-0001"}           # id optional (derived from audio path)

Relative audio paths resolve against the manifest file's directory, so a
manifest + audio tree moves as one unit.  Audio decodes through
data/audio.read_audio (stdlib wav + the self-contained native FLAC
decoder) and is resampled to the target rate.  ``write_manifest`` is the
inverse, for dataset tooling and round-trip tests.

No reference implementation exists for this capability (the
reference mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

import numpy as np

from mogasr_torch.data.audio import read_audio


def read_manifest(
    path: str,
    max_utts: int = 0,
    target_sr: int = 16000,
) -> List[Tuple[str, np.ndarray, List[str]]]:
    """[(utt_id, float32 wave @ target_sr, words)] from a JSONL manifest.

    Raises ValueError naming the offending LINE NUMBER on malformed JSON,
    missing keys, or unreadable audio — a bad 10k-line manifest must point
    at its bad line, not stack-trace from deep inside the audio decoder."""
    base = os.path.dirname(os.path.abspath(path))
    out: List[Tuple[str, np.ndarray, List[str]]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad json: {e}") from None
            if "audio" not in doc or "text" not in doc:
                raise ValueError(
                    f"{path}:{lineno}: need 'audio' and 'text' keys "
                    f"(got {sorted(doc)})"
                )
            audio = doc["audio"]
            if not os.path.isabs(audio):
                audio = os.path.join(base, audio)
            utt_id = doc.get("id") or os.path.splitext(
                os.path.basename(audio))[0]
            try:
                wave, _sr = read_audio(audio, target_sr=target_sr)
            except (OSError, ValueError) as e:
                raise ValueError(
                    f"{path}:{lineno}: cannot read {audio!r}: {e}"
                ) from None
            out.append((utt_id, wave, doc["text"].lower().split()))
            if max_utts and len(out) >= max_utts:
                break
    return out


def write_manifest(path: str, entries: Iterable[Dict]) -> int:
    """Write entries (dicts with at least audio+text) as JSONL; returns the
    number written."""
    n = 0
    with open(path, "w") as f:
        for doc in entries:
            if "audio" not in doc or "text" not in doc:
                raise ValueError(f"manifest entry needs audio+text: {doc}")
            f.write(json.dumps(doc) + "\n")
            n += 1
    return n

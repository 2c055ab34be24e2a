"""Speaker diarization on the card, who spoke when over a long multi-speaker
recording: the twin of the reference's cli/diarize.py.

    python -m mogasr_torch.cli.diarize (--synthetic-session N_UTTS [--speakers 3] | --wav FILE) \\
        [--n-speakers N] [--threshold 0.35] [--window 1.5] [--hop 0.75] [--rank 8] [--ubm-components 16] \\
        [--out turns.jsonl] [--rttm out.rttm] [--run-dir DIR] [--device cpu]

A UBM + total-variability model is trained (``diarize.train_diarizer``) on
the session's own training corpus (``--synthetic-session``) or on the
recording's VAD segments (``--wav``); then VAD -> fixed windows through the
port's front end -> i-vectors (statistics and E-step on the card) ->
agglomerative clustering -> speaker turns (``diarize.diarize_wave``).
``--synthetic-session`` builds a ground-truth session from v2 speakers
(``build_session``, the reference's, bit for bit) and scores the result with
DER (``eval.diarization.der``, collar 0.25 s). The summary record is the
reference's, logged to <run-dir>/metrics.jsonl and printed; ``--out`` writes
the turns as JSONL, ``--rttm`` as NIST RTTM. Runs on ``--device`` (default
cuda).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mogasr_torch.cli.common import add_run_args, device_of, make_logger
from mogasr_torch.config import FrontendConfig
from mogasr_torch.diarize import DiarizeConfig, diarize_wave, train_diarizer
from mogasr_torch.utils.metrics import Timer


def build_session(n_speakers: int, n_utts: int, seed: int = 0):
    """Concatenate v2 utterances round-robin across speakers with silence
    gaps -> (wave, ref_segments, train_utts for the UBM/TV model)."""
    from mogasr_torch.data import synthetic as syn

    speakers = syn.make_speakers(
        n_speakers, seed=seed + 1,
        scale_range=(0.84, 1.16), tilt_range=(-0.4, 0.4),
        level_range_db=(-6.0, 0.0),
    )
    utts = syn.make_corpus_v2(n_utts, speakers=speakers, words_per_utt=(6, 10), seed=seed)
    sr = 16000
    gap = int(0.4 * sr)
    rng = np.random.default_rng(seed + 7)
    pieces, refs = [], []
    t = 0
    for u in utts:
        pieces.append(np.zeros(gap + rng.integers(0, gap), np.float32))
        t += len(pieces[-1])
        pieces.append(np.asarray(u.wave, np.float32))
        refs.append((t / sr, (t + len(u.wave)) / sr, u.speaker))
        t += len(u.wave)
    train = syn.make_corpus_v2(max(32, 4 * n_speakers), speakers=speakers, words_per_utt=(6, 10), seed=seed + 100)
    return np.concatenate(pieces), refs, [(u.utt_id, u.wave, u.words) for u in train]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_run_args(p)
    p.add_argument("--wav", help="input recording (wav)")
    p.add_argument("--synthetic-session", type=int, metavar="N_UTTS",
                   help="build an N_UTTS-utterance multi-speaker session with known ground truth and report DER")
    p.add_argument("--speakers", type=int, default=3, help="speakers in the synthetic session")
    p.add_argument("--n-speakers", type=int, default=0, help="known speaker count (0 = threshold clustering)")
    p.add_argument("--threshold", type=float, default=0.35,
                   help="AHC cosine-distance stop (unknown speaker count)")
    p.add_argument("--window", type=float, default=1.5)
    p.add_argument("--hop", type=float, default=0.75)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--ubm-components", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="write speaker turns as JSONL")
    p.add_argument("--rttm", help="write NIST RTTM")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    fcfg = FrontendConfig(cmvn="none")
    logger = make_logger(args)

    refs = None
    if args.synthetic_session:
        wave, refs, train_utts = build_session(args.speakers, args.synthetic_session, seed=args.seed)
        rec_id = "synthetic-session"
    elif args.wav:
        from mogasr_torch.data.audio import read_audio

        wave, sr = read_audio(args.wav)
        if sr != fcfg.sample_rate:
            from mogasr_torch.data.audio import resample

            wave = resample(wave, sr, fcfg.sample_rate)
        # no session-matched corpus: train the UBM/TV on the recording's own
        # VAD windows (unsupervised, standard for single-file use)
        from mogasr_torch.frontend.vad import segment_utterances

        spans = segment_utterances(wave, fcfg)
        train_utts = [(f"win{i:04d}", wave[s:e], []) for i, (s, e) in enumerate(spans)]
        rec_id = os.path.basename(args.wav)
    else:
        raise SystemExit("need --wav or --synthetic-session")

    with Timer() as tt:
        ubm, t_mat = train_diarizer(train_utts, fcfg, n_components=args.ubm_components, rank=args.rank,
                                    device=device)
    with Timer() as td:
        turns = diarize_wave(wave, fcfg, ubm, t_mat, n_speakers=args.n_speakers or None,
                             dcfg=DiarizeConfig(window_s=args.window, hop_s=args.hop, threshold=args.threshold))
    n_found = len({lab for _s, _e, lab in turns})
    summary = {
        "stage": "diarize_done", "recording_s": round(len(wave) / 16000.0, 1),
        "turns": len(turns), "speakers_found": n_found,
        "train_wall_s": round(tt.seconds, 2), "diarize_wall_s": round(td.seconds, 2),
    }
    if refs is not None:
        from mogasr_torch.eval.diarization import der

        scores = der(refs, turns, collar_s=0.25)
        summary.update({k: round(v, 4) for k, v in scores.items()})
    logger.log(summary)
    print(json.dumps(summary))

    if args.out:
        with open(args.out, "w") as f:
            for s, e, lab in turns:
                f.write(json.dumps({"start": s, "end": e, "speaker": f"spk{lab}"}) + "\n")
    if args.rttm:
        with open(args.rttm, "w") as f:
            for s, e, lab in turns:
                f.write(f"SPEAKER {rec_id} 1 {s:.3f} {e - s:.3f} <NA> <NA> spk{lab} <NA> <NA>\n")


if __name__ == "__main__":
    main()

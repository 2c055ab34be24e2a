"""Speaker diarization in PyTorch: the port of mogasr/diarize.py.

VAD -> windowed i-vectors -> agglomerative clustering, over long
multi-speaker recordings:

  1. energy VAD (``frontend/vad.py``, the copy) finds speech regions;
  2. speech is cut into fixed-length overlapping windows, so the whole
     recording featurizes as one batch through the port's front end
     (``pipeline.frontend_for`` at the window length), the ragged tail
     handled by the front end's per-utterance frame masking;
  3. each window gets an i-vector (``am/ivector.py``: the statistics and the
     E-step on the device of the UBM) against a UBM + total variability
     model (``train_diarizer`` or supplied);
  4. average-linkage agglomerative clustering on cosine distance of the
     centered, length-normalized i-vectors (host numpy, the reference's
     code), cut at ``n_speakers`` when known, else at a cosine-distance
     ``threshold``, then a spherical k-means polish;
  5. window labels vote per 10 ms step and merge into speaker turns.

Scoring lives in ``mogasr_torch.eval.diarization`` (DER with optimal speaker
mapping).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mogasr_torch.am import ivector as iv
from mogasr_torch.am.gmm import GmmSet
from mogasr_torch.config import FrontendConfig
from mogasr_torch.frontend.vad import VadConfig, segment_utterances


@dataclasses.dataclass(frozen=True)
class DiarizeConfig:
    window_s: float = 1.5      # i-vector extraction window
    hop_s: float = 0.75        # window hop (overlap smooths boundaries)
    threshold: float = 0.35    # AHC stop: min cosine-distance between clusters
    min_window_frames: int = 20  # drop windows with fewer valid frames


def ahc_labels(
    vecs: np.ndarray,                 # [N, R] length-normalized vectors
    n_clusters: Optional[int] = None,
    threshold: float = 0.35,
) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance.

    Merges the closest pair until ``n_clusters`` remain (when given), else
    until the closest pair is farther than ``threshold``."""
    n = len(vecs)
    if n == 0:
        return np.zeros(0, np.int32)
    clusters: List[List[int]] = [[i] for i in range(n)]
    sim = vecs @ vecs.T

    def avg_dist(a: List[int], b: List[int]) -> float:
        return 1.0 - float(sim[np.ix_(a, b)].mean())

    while len(clusters) > 1:
        best = (None, None, np.inf)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = avg_dist(clusters[i], clusters[j])
                if d < best[2]:
                    best = (i, j, d)
        i, j, d = best
        if n_clusters is not None:
            if len(clusters) <= n_clusters:
                break
        elif d > threshold:
            break
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]
    labels = np.zeros(n, np.int32)
    for k, c in enumerate(clusters):
        labels[c] = k
    return labels


def _kmeans_refine(vecs: np.ndarray, labels: np.ndarray, max_iters: int = 10) -> np.ndarray:
    """Spherical k-means polish of AHC labels: reassign each window to its
    nearest cluster centroid (cosine) until stable."""
    k = int(labels.max()) + 1 if len(labels) else 0
    if k < 2:
        return labels
    for _ in range(max_iters):
        cents = []
        for c in range(k):
            rows = vecs[labels == c]
            if len(rows) == 0:
                return labels  # a cluster emptied: keep the last stable state
            m = rows.mean(0)
            cents.append(m / max(np.linalg.norm(m), 1e-8))
        new = np.argmax(vecs @ np.stack(cents).T, axis=1).astype(np.int32)
        if (new == labels).all():
            break
        labels = new
    return labels


def _speech_windows(spans: Sequence[Tuple[int, int]], win: int, hop: int) -> List[Tuple[int, int]]:
    """Fixed-length window starts covering each speech span (sample units).
    The final window of a span is right-aligned so the tail is covered."""
    out: List[Tuple[int, int]] = []
    for s, e in spans:
        if e - s <= win:
            out.append((s, min(e, s + win)))
            continue
        t = s
        while t + win < e:
            out.append((t, t + win))
            t += hop
        out.append((e - win, e))
    return out


def diarize_wave(
    wave: np.ndarray,
    fcfg: FrontendConfig,
    ubm: GmmSet,
    t_mat: np.ndarray,
    n_speakers: Optional[int] = None,
    dcfg: DiarizeConfig = DiarizeConfig(),
    vcfg: VadConfig = VadConfig(),
) -> List[Tuple[float, float, int]]:
    """Long recording -> [(start_s, end_s, speaker_label)] speaker turns.

    The windows featurize on the device of ``ubm``. fcfg gets cmvn='none'
    (utterance CMVN would strip the speaker cues); the UBM/TV model must have
    been trained under the same convention (train_diarizer does)."""
    from mogasr_torch.pipeline import frontend_for

    fcfg = dataclasses.replace(fcfg, cmvn="none")
    sr = fcfg.sample_rate
    win = int(dcfg.window_s * sr)
    hop = int(dcfg.hop_s * sr)
    spans = segment_utterances(wave, fcfg, vcfg)
    windows = _speech_windows(spans, win, hop)
    if not windows:
        return []

    waves = np.zeros((len(windows), win), np.float32)
    n_samples = np.zeros(len(windows), np.int32)
    for i, (s, e) in enumerate(windows):
        chunk = np.asarray(wave[s:e], np.float32)
        waves[i, : len(chunk)] = chunk
        n_samples[i] = len(chunk)
    dev = ubm.means.device
    fe = frontend_for(fcfg, win, dev)
    feats, n_frames = fe(torch.as_tensor(waves, device=dev), torch.as_tensor(n_samples, device=dev))

    keep = n_frames.cpu().numpy() >= dcfg.min_window_frames
    if not keep.any():
        return []
    stats = iv.accumulate_bw_stats(feats, n_frames, ubm)
    keep_t = torch.as_tensor(keep, device=stats.n.device)
    vecs = iv.extract_ivectors(iv.BwStats(stats.n[keep_t], stats.f[keep_t]), ubm, t_mat)
    vecs = iv.length_normalize(vecs - vecs.mean(0))
    labels = ahc_labels(vecs, n_clusters=n_speakers, threshold=dcfg.threshold)
    labels = _kmeans_refine(vecs, labels)

    # frame-level voting at 10 ms: overlapping windows vote their label
    # over their extent; argmax per frame; contiguous runs become turns
    step = sr // 100
    n_steps = int(np.ceil(len(wave) / step))
    n_labs = int(labels.max()) + 1
    votes = np.zeros((n_steps, n_labs), np.int32)
    kept = [w for w, k in zip(windows, keep) if k]
    for (s, e), lab in zip(kept, labels):
        votes[s // step: -(-e // step), lab] += 1
    speech = votes.sum(-1) > 0
    track = np.where(speech, votes.argmax(-1), -1)
    turns: List[Tuple[float, float, int]] = []
    t = 0
    while t < n_steps:
        if track[t] < 0:
            t += 1
            continue
        j = t
        while j < n_steps and track[j] == track[t]:
            j += 1
        turns.append((
            round(t * step / sr, 3),
            round(min(j * step, len(wave)) / sr, 3),
            int(track[t]),
        ))
        t = j
    return turns


def train_diarizer(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    fcfg: FrontendConfig,
    n_components: int = 16,
    rank: int = 8,
    ubm_iters: int = 8,
    tv_iters: int = 10,
    *,
    device: torch.device,
) -> Tuple[GmmSet, np.ndarray]:
    """Train the (UBM, T) pair for diarization from a corpus (cmvn='none'),
    featurized on ``device``."""
    from mogasr_torch.config import BatchConfig
    from mogasr_torch.pipeline import featurize

    fcfg = dataclasses.replace(fcfg, cmvn="none")
    bcfg = BatchConfig(batch_size=8, bucket_boundaries=(300, 500, 800, 1200))
    batches = featurize(utts, fcfg, bcfg, device)
    ubm = iv.train_ubm(batches, n_components=n_components, n_iters=ubm_iters)
    stats = [iv.accumulate_bw_stats(fb.feats, fb.n_frames, ubm) for fb in batches]
    t_mat = iv.train_total_variability(stats, ubm, rank=rank, n_iters=tv_iters)
    return ubm, t_mat

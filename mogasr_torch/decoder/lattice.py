"""Word lattices, exact N-best extraction, and LM rescoring (host side).

The port's copy of mogasr/decoder/lattice.py, its imports pointed at mogasr_torch.

The device LM-Viterbi pass (``viterbi_lm(..., with_lattice=True)``) emits,
for every (frame t, chain c), the best-scoring token that ends chain c at t:
its total path score, its chain-entry frame, and the cumulative score at
entry INCLUDING the first-pass LM transition. Subtracting the entry base
yields an LM-FREE arc score (emissions + intra-chain transitions + pron
prior + insertion penalty + exit weight), so the lattice can be re-searched
exactly under ANY n-gram LM — the standard two-pass lattice-rescoring
architecture (first pass bigram on device, second pass trigram/N-best on the
tiny host lattice).

Caveat (inherent to single-pass lattices, as in Kaldi/HTK): the recorded arc
for (t, c) is the one on the best FIRST-PASS path; a second-pass LM could in
principle prefer a start time the first pass recombined away. With a weak or
uniform first-pass LM the lattice is near-exhaustive.

Host-side by design: lattices are [T, C]-sized (thousands of arcs); all
FLOPs stay on device in the first pass. SURVEY.md §2 "Beam decoder" row —
this supplies the lattice/N-best capability beyond the 1-best decoders.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mogasr_torch.lm.ngram import lm_stepper

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Arc:
    start: int    # first frame of the word token (inclusive)
    end: int      # last frame (inclusive)
    chain: int    # graph chain index (identifies the pronunciation variant)
    word: str
    score: float  # LM-free score: emissions + transitions + pron prior


@dataclasses.dataclass
class Lattice:
    n_frames: int
    arcs: List[Arc]

    @property
    def arcs_by_end(self) -> List[List[Arc]]:
        by_end: List[List[Arc]] = [[] for _ in range(self.n_frames)]
        for a in self.arcs:
            by_end[a.end].append(a)
        return by_end


def lattices_from_pass(
    lat_score,    # [B, T, C] best path score ending chain c at frame t
    lat_start,    # [B, T, C] that token's entry frame
    lat_base,     # [B, T, C] cumulative score at entry (incl. LM transition)
    n_frames,     # [B]
    labels: Sequence[str],          # chain -> word label
    prune_beam: Optional[float] = None,
) -> List[Lattice]:
    """Materialize per-utterance word lattices from the device pass.

    prune_beam: drop arcs whose total path score falls more than this below
    the best score at the same end frame (None = keep everything viable).
    """
    lat_score = np.asarray(lat_score)
    lat_start = np.asarray(lat_start)
    lat_base = np.asarray(lat_base)
    n_frames = np.asarray(n_frames)
    B, T, C = lat_score.shape
    out = []
    for b in range(B):
        n = int(n_frames[b])
        arcs: List[Arc] = []
        sc = lat_score[b, :n]                       # [n, C]
        ok = sc > NEG_INF / 2
        if prune_beam is not None:
            best_t = np.max(np.where(ok, sc, NEG_INF), axis=1, keepdims=True)
            ok &= sc >= best_t - prune_beam
        ts, cs = np.nonzero(ok)
        for t, c in zip(ts.tolist(), cs.tolist()):
            arcs.append(
                Arc(
                    start=int(lat_start[b, t, c]),
                    end=t,
                    chain=c,
                    word=labels[c],
                    score=float(sc[t, c] - lat_base[b, t, c]),
                )
            )
        out.append(Lattice(n_frames=n, arcs=arcs))
    return out


def lattice_nbest(
    lat: Lattice,
    lm,                     # BigramLm or TrigramLm
    n: int,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
) -> List[Tuple[List[str], float]]:
    """Exact top-n paths through the lattice under ``lm``.

    DP over (frame boundary, LM context) keeping n best partial paths per
    state — exact for the lattice (the LM context subsumes all path history
    the LM can see). Hypotheses identical after drop_tokens are merged,
    keeping the best score. Returns [(words, total_logp)] best-first.
    """
    idx = {t: i for i, t in enumerate(lm.tokens)}
    start_fn, step_fn, final_fn = lm_stepper(lm)

    # table[pos][ctx] = list of (score, raw word tuple), len <= n
    table: Dict[int, Dict[tuple, List[Tuple[float, tuple]]]] = {
        0: {start_fn(): [(0.0, ())]}
    }

    def push(bucket: List[Tuple[float, tuple]], item: Tuple[float, tuple]):
        bucket.append(item)
        if len(bucket) > 4 * n:  # keep buckets small; exact trim at read
            bucket.sort(key=lambda x: -x[0])
            del bucket[2 * n:]

    for t, arcs in enumerate(lat.arcs_by_end):
        for arc in arcs:
            src = table.get(arc.start)
            if not src:
                continue
            if arc.word not in idx:
                raise KeyError(
                    f"lattice word {arc.word!r} not in LM vocabulary — "
                    "estimate the rescoring LM over the decode-graph labels"
                )
            w = idx[arc.word]
            dst = table.setdefault(t + 1, {})
            for ctx, cands in src.items():
                lp, nctx = step_fn(ctx, w)
                bucket = dst.setdefault(nctx, [])
                for sc, words in sorted(cands, key=lambda x: -x[0])[:n]:
                    push(bucket, (sc + arc.score + lp, words + (arc.word,)))

    finals: List[Tuple[float, tuple]] = []
    for ctx, cands in table.get(lat.n_frames, {}).items():
        f = final_fn(ctx)
        for sc, words in cands:
            finals.append((sc + f, words))
    finals.sort(key=lambda x: -x[0])

    seen = set()
    out: List[Tuple[List[str], float]] = []
    for sc, words in finals:
        clean = tuple(w for w in words if w not in drop_tokens)
        if clean in seen:
            continue
        seen.add(clean)
        out.append((list(clean), sc))
        if len(out) == n:
            break
    return out


def rescore_lattice(
    lat: Lattice, lm, drop_tokens: Tuple[str, ...] = ("<sil>", "sil")
) -> Tuple[List[str], float]:
    """1-best under a (usually stronger) second-pass LM."""
    best = lattice_nbest(lat, lm, 1, drop_tokens=drop_tokens)
    return best[0] if best else ([], NEG_INF)


def lattice_oracle_errors(
    lat: Lattice,
    ref: Sequence[str],
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
) -> int:
    """Minimum word edit distance achievable by ANY path through the lattice
    (the lattice oracle). DP state: (frame boundary, #ref words consumed) ->
    min edits; silence arcs are free."""
    R = len(ref)
    INF = 10**9
    # best[pos] = dict r -> min edits
    best: Dict[int, Dict[int, int]] = {0: {0: 0}}
    for t, arcs in enumerate(lat.arcs_by_end):
        for arc in arcs:
            src = best.get(arc.start)
            if not src:
                continue
            dst = best.setdefault(t + 1, {})
            is_sil = arc.word in drop_tokens
            for r, e in src.items():
                if is_sil:
                    cand = [(r, e)]
                else:
                    cand = [(r, e + 1)]  # insertion (no ref consumed)
                    # delete r..r2-1 from the ref, then align arc to ref[r2]
                    for r2 in range(r, R):
                        cand.append((r2 + 1, e + (r2 - r) + (arc.word != ref[r2])))
                for nr, ne in cand:
                    if ne < dst.get(nr, INF):
                        dst[nr] = ne
    end = best.get(lat.n_frames, {})
    if not end:
        return R  # no complete path: all deletions
    # remaining refs are deletions
    return min(e + (R - r) for r, e in end.items())


# --------------------------------------------------------------------------
# Text archive I/O (interop artifact, exact roundtrip)
# --------------------------------------------------------------------------


def write_lattices(path: str, lattices, append: bool = False) -> None:
    """Write an utterance->lattice archive as text.

    Format (one section per utterance, Kaldi-archive-flavored):
        <utt_id> <n_frames>
        <start> <end> <chain> <word> <score-repr>
        ...
        .
    Scores are written with repr() so read_lattices roundtrips exactly.
    ``lattices``: dict or iterable of (utt_id, Lattice)."""
    items = lattices.items() if hasattr(lattices, "items") else lattices
    with open(path, "a" if append else "w") as f:
        for uid, lat in items:
            f.write(f"{uid} {lat.n_frames}\n")
            for a in lat.arcs:
                f.write(f"{a.start} {a.end} {a.chain} {a.word} {a.score!r}\n")
            f.write(".\n")


def read_lattices(path: str) -> Dict[str, Lattice]:
    """Inverse of write_lattices (exact roundtrip; tested)."""
    out: Dict[str, Lattice] = {}
    with open(path) as f:
        header: Optional[Tuple[str, int]] = None
        arcs: List[Arc] = []
        for line in f:
            line = line.rstrip("\n")
            if header is None:
                if not line.strip():
                    continue
                uid, nf = line.rsplit(" ", 1)
                header = (uid, int(nf))
                arcs = []
            elif line == ".":
                out[header[0]] = Lattice(header[1], arcs)
                header = None
            else:
                s, e, c, w, sc = line.split(" ", 4)
                arcs.append(Arc(int(s), int(e), int(c), w, float(sc)))
    if header is not None:
        raise ValueError(f"truncated lattice archive: {path}")
    return out

"""N-gram language models for decoding (host-side estimation, device arrays).

The port's copy of mogasr/lm/ngram.py, its imports pointed at mogasr_torch.

Adds bigram word-pair weighting to the token-passing decoder: the loop-state
machinery in mogasr_torch.decoder keeps per-chain LM context exact (the loop state
is factored per chain, not collapsed — see decoder/lm_viterbi.py). Estimation
is add-alpha-smoothed counting over transcripts; silence is modeled as an
ordinary token (documented simplification vs LM-transparent silence).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BOS = "<s>"
EOS = "</s>"


@dataclasses.dataclass
class BigramLm:
    tokens: List[str]          # decoding tokens (chains), index == chain id
    pair_logp: np.ndarray      # [C, C]: log P(token c' | token c)
    init_logp: np.ndarray      # [C]:    log P(token c | <s>)
    final_logp: np.ndarray     # [C]:    log P(</s> | token c)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


def estimate_bigram(
    transcripts: Sequence[Sequence[str]],
    tokens: Sequence[str],
    alpha: float = 0.5,
) -> BigramLm:
    """Add-alpha bigram over the given token list (unknown words skipped)."""
    tokens = list(tokens)
    idx = {t: i for i, t in enumerate(tokens)}
    C = len(tokens)
    pair = np.full((C, C), alpha, np.float64)
    init = np.full(C, alpha, np.float64)
    final = np.full(C, alpha, np.float64)
    for words in transcripts:
        seq = [idx[w] for w in words if w in idx]
        if not seq:
            continue
        init[seq[0]] += 1
        for a, b in zip(seq, seq[1:]):
            pair[a, b] += 1
        final[seq[-1]] += 1
    tiny = 1e-30  # alpha=0 rows: unseen events get log(0) ~ -inf without warnings
    pair_logp = np.log(np.maximum(pair, tiny)) - np.log(
        np.maximum(pair.sum(1, keepdims=True) + final.reshape(-1, 1), tiny)
    )
    init_logp = np.log(np.maximum(init, tiny)) - np.log(max(init.sum(), tiny))
    final_logp = np.log(np.maximum(final, tiny)) - np.log(np.maximum(pair.sum(1) + final, tiny))
    return BigramLm(
        tokens=tokens,
        pair_logp=pair_logp.astype(np.float32),
        init_logp=init_logp.astype(np.float32),
        final_logp=final_logp.astype(np.float32),
    )


@dataclasses.dataclass
class TrigramLm:
    """Interpolated trigram LM over a small closed vocabulary.

    Dense [C+1, C+1, C+1] table: context slots use index C for <s> (BOS),
    the event slot uses index C for </s> (EOS). logp[a, b, w] =
    log P(w | a, b). Dense storage is deliberate — decode vocabularies here
    are closed and small (the [BJ] spec's word loop); a real open-vocab LM
    would swap in a hashed/backoff store behind the same step API.
    """

    tokens: List[str]
    logp: np.ndarray  # [C+1, C+1, C+1] float32

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def bos(self) -> int:
        return len(self.tokens)

    @property
    def eos(self) -> int:
        return len(self.tokens)

    # --- host-side stepping API shared with BigramLm (lattice rescoring) ---
    def start_ctx(self) -> Tuple[int, int]:
        return (self.bos, self.bos)

    def step(self, ctx: Tuple[int, int], w: int) -> Tuple[float, Tuple[int, int]]:
        a, b = ctx
        return float(self.logp[a, b, w]), (b, w)

    def final(self, ctx: Tuple[int, int]) -> float:
        a, b = ctx
        return float(self.logp[a, b, self.eos])


def bigram_start_ctx(lm: BigramLm) -> Tuple[int]:
    return (-1,)


def bigram_step(lm: BigramLm, ctx: Tuple[int], w: int) -> Tuple[float, Tuple[int]]:
    (prev,) = ctx
    lp = float(lm.init_logp[w]) if prev < 0 else float(lm.pair_logp[prev, w])
    return lp, (w,)


def bigram_final(lm: BigramLm, ctx: Tuple[int]) -> float:
    (prev,) = ctx
    return 0.0 if prev < 0 else float(lm.final_logp[prev])


def lm_stepper(lm):
    """(start_ctx, step, final) closures for BigramLm or TrigramLm."""
    if isinstance(lm, TrigramLm):
        return lm.start_ctx, lm.step, lm.final
    return (
        lambda: bigram_start_ctx(lm),
        lambda ctx, w: bigram_step(lm, ctx, w),
        lambda ctx: bigram_final(lm, ctx),
    )


def estimate_trigram(
    transcripts: Sequence[Sequence[str]],
    tokens: Sequence[str],
    lambdas: Tuple[float, float, float] = (0.7, 0.2, 0.1),
    alpha: float = 0.5,
) -> TrigramLm:
    """Jelinek-Mercer-interpolated trigram: P = l3*ML3 + l2*ML2 + l1*P1(+alpha).

    Every (a, b) context row (including BOS contexts) normalizes over the
    C words + EOS; unknown transcript words are skipped, matching
    estimate_bigram.
    """
    tokens = list(tokens)
    idx = {t: i for i, t in enumerate(tokens)}
    C = len(tokens)
    S = C + 1  # sentinel index: BOS in contexts, EOS in events
    c3 = np.zeros((S, S, S), np.float64)
    c2 = np.zeros((S, S), np.float64)
    c1 = np.zeros(S, np.float64)
    for words in transcripts:
        seq = [idx[w] for w in words if w in idx]
        if not seq:
            continue
        padded = [C, C] + seq + [C]  # [BOS, BOS, w1..wn, EOS]
        for i in range(2, len(padded)):
            a, b, w = padded[i - 2], padded[i - 1], padded[i]
            c3[a, b, w] += 1
            c2[b, w] += 1
            c1[w] += 1
    l3, l2, l1 = lambdas
    # unigram with add-alpha over the C+1 events (EOS included)
    p1 = (c1 + alpha) / (c1.sum() + alpha * S)
    with np.errstate(invalid="ignore", divide="ignore"):
        p2 = np.where(c2.sum(1, keepdims=True) > 0, c2 / np.maximum(c2.sum(1, keepdims=True), 1), 0.0)
        p3 = np.where(
            c3.sum(2, keepdims=True) > 0, c3 / np.maximum(c3.sum(2, keepdims=True), 1), 0.0
        )
    p = l3 * p3 + l2 * p2[None, :, :] + l1 * p1[None, None, :]
    # renormalize rows exactly (unseen-context rows fall back to l2/l1 mass)
    p = p / p.sum(2, keepdims=True)
    return TrigramLm(tokens=tokens, logp=np.log(np.maximum(p, 1e-30)).astype(np.float32))


def estimate_bigram_kn(
    transcripts: Sequence[Sequence[str]],
    tokens: Sequence[str],
    discount: float = 0.75,
) -> BigramLm:
    """Interpolated Kneser-Ney bigram.

    P(w|a) = max(n(a,w)-D, 0)/n(a,.) + lam(a) * Pcont(w), with the
    continuation unigram Pcont(w) proportional to the number of DISTINCT
    contexts w follows — the property add-alpha lacks (a word frequent in
    one context only, e.g. "york" after "new", gets low continuation mass).
    Contexts: C words + BOS; events: C words + EOS.
    """
    tokens = list(tokens)
    idx = {t: i for i, t in enumerate(tokens)}
    C = len(tokens)
    S = C + 1  # context BOS / event EOS sentinel index
    n = np.zeros((S, S), np.float64)
    for words in transcripts:
        seq = [idx[w] for w in words if w in idx]
        if not seq:
            continue
        padded = [C] + seq + [C]
        for a, w in zip(padded, padded[1:]):
            n[a, w] += 1
    D = float(discount)
    types_following = (n > 0).sum(0).astype(np.float64)  # N1+(., w)
    p_cont = types_following / max(types_following.sum(), 1.0)
    if p_cont.sum() <= 0:
        p_cont = np.full(S, 1.0 / S)
    row_tot = n.sum(1)
    row_types = (n > 0).sum(1).astype(np.float64)
    p = np.empty((S, S), np.float64)
    for a in range(S):
        if row_tot[a] > 0:
            lam = D * row_types[a] / row_tot[a]
            p[a] = np.maximum(n[a] - D, 0.0) / row_tot[a] + lam * p_cont
        else:
            p[a] = p_cont
    p /= p.sum(1, keepdims=True)
    tiny = 1e-30
    # BigramLm convention: init row normalizes over words only (no empty utts)
    init = p[C, :C] / max(p[C, :C].sum(), tiny)
    return BigramLm(
        tokens=tokens,
        pair_logp=np.log(np.maximum(p[:C, :C], tiny)).astype(np.float32),
        init_logp=np.log(np.maximum(init, tiny)).astype(np.float32),
        final_logp=np.log(np.maximum(p[:C, C], tiny)).astype(np.float32),
    )


def estimate_trigram_kn(
    transcripts: Sequence[Sequence[str]],
    tokens: Sequence[str],
    discount: float = 0.75,
) -> TrigramLm:
    """Interpolated Kneser-Ney trigram (dense closed-vocab, TrigramLm table).

    Highest order discounts real counts; the bigram level uses CONTINUATION
    counts N1+(., b, w) (how many distinct left contexts precede (b, w)),
    and the unigram level continuation types — standard interpolated KN.
    """
    tokens = list(tokens)
    idx = {t: i for i, t in enumerate(tokens)}
    C = len(tokens)
    S = C + 1
    c3 = np.zeros((S, S, S), np.float64)
    for words in transcripts:
        seq = [idx[w] for w in words if w in idx]
        if not seq:
            continue
        padded = [C, C] + seq + [C]
        for i in range(2, len(padded)):
            c3[padded[i - 2], padded[i - 1], padded[i]] += 1
    D = float(discount)
    # continuation bigram counts: distinct a preceding (b, w)
    cont2 = (c3 > 0).sum(0).astype(np.float64)          # [S(b), S(w)]
    cont1 = (cont2 > 0).sum(0).astype(np.float64)       # [S(w)] distinct b before w
    p1 = cont1 / max(cont1.sum(), 1.0)
    if p1.sum() <= 0:
        p1 = np.full(S, 1.0 / S)
    # KN bigram from continuation counts
    b_tot = cont2.sum(1)
    b_types = (cont2 > 0).sum(1).astype(np.float64)
    p2 = np.empty((S, S), np.float64)
    for b in range(S):
        if b_tot[b] > 0:
            lam = D * b_types[b] / b_tot[b]
            p2[b] = np.maximum(cont2[b] - D, 0.0) / b_tot[b] + lam * p1
        else:
            p2[b] = p1
    # top level: real counts
    t_tot = c3.sum(2)
    t_types = (c3 > 0).sum(2).astype(np.float64)
    p3 = np.empty((S, S, S), np.float64)
    for a in range(S):
        for b in range(S):
            if t_tot[a, b] > 0:
                lam = D * t_types[a, b] / t_tot[a, b]
                p3[a, b] = np.maximum(c3[a, b] - D, 0.0) / t_tot[a, b] + lam * p2[b]
            else:
                p3[a, b] = p2[b]
    p3 /= p3.sum(2, keepdims=True)
    return TrigramLm(
        tokens=tokens, logp=np.log(np.maximum(p3, 1e-30)).astype(np.float32)
    )


def sequence_logp(lm, words: Sequence[str]) -> float:
    """Total log P(words </s>) under a BigramLm or TrigramLm (host-side)."""
    idx = {t: i for i, t in enumerate(lm.tokens)}
    start, step, final = lm_stepper(lm)
    ctx = start()
    total = 0.0
    for w in words:
        lp, ctx = step(ctx, idx[w])
        total += lp
    return total + final(ctx)


def grammar_bigram(
    sentences: Sequence[Sequence[str]],
    tokens: Optional[Sequence[str]] = None,
    transparent: Sequence[str] = ("<sil>",),
) -> BigramLm:
    """Hard command-grammar "LM": FSA-style constrained decoding.

    Only the word adjacencies / sentence starts / sentence ends attested in
    ``sentences`` get probability mass (uniform over each state's allowed
    continuations); everything else is -inf. Decoding with this LM through
    decoder.lm_viterbi therefore only ever produces grammar-consistent word
    sequences — command-and-control style decoding through the SAME exact
    kernel as n-gram decoding (a grammar IS a bigram with hard zeros here).

    transparent: tokens (silence) allowed between any two grammar words and
    at the edges. Known approximation: a bigram cannot carry context across
    a transparent token, so "a <sil> b" is accepted whenever some grammar
    word may precede sil and some may follow — the standard bigram-grammar
    silence caveat.
    """
    words = sorted({w for s in sentences for w in s})
    if tokens is None:
        tokens = words + [t for t in transparent if t not in words]
    tokens = list(tokens)
    idx = {t: i for i, t in enumerate(tokens)}
    missing = sorted({w for s in sentences for w in s if w not in idx})
    if missing:
        # silently dropping an OOV grammar word would splice its neighbors
        # into an adjacency the grammar never licensed — refuse instead
        raise ValueError(
            f"grammar words not in the decode vocabulary: {missing[:10]}"
        )
    C = len(tokens)
    allowed_pair = np.zeros((C, C), bool)
    allowed_init = np.zeros(C, bool)
    allowed_final = np.zeros(C, bool)
    for s in sentences:
        seq = [idx[w] for w in s]
        if not seq:
            continue
        allowed_init[seq[0]] = True
        allowed_final[seq[-1]] = True
        for a, b in zip(seq, seq[1:]):
            allowed_pair[a, b] = True
    for t in transparent:
        if t not in idx:
            continue
        ti = idx[t]
        # sil may follow anything that has any continuation, precede anything
        # that has any predecessor (incl. edges), and self-loop
        allowed_pair[:, ti] = True
        allowed_pair[ti, :] = allowed_pair.any(axis=0) | allowed_init
        allowed_pair[ti, ti] = True
        allowed_init[ti] = True
        allowed_final[ti] = True
    NEG = np.float32(-1e30)  # hard zero: forbidden, not merely improbable
    n_out = allowed_pair.sum(1) + allowed_final
    pair_logp = np.where(
        allowed_pair, -np.log(np.maximum(n_out, 1))[:, None], NEG
    ).astype(np.float32)
    final_logp = np.where(
        allowed_final, -np.log(np.maximum(n_out, 1)), NEG
    ).astype(np.float32)
    init_logp = np.where(
        allowed_init, -np.log(max(allowed_init.sum(), 1)), NEG
    ).astype(np.float32)
    return BigramLm(
        tokens=tokens,
        pair_logp=pair_logp,
        init_logp=init_logp,
        final_logp=final_logp,
    )


def uniform_bigram(tokens: Sequence[str]) -> BigramLm:
    """LM with uniform transitions — decodes identically to the LM-free
    unigram loop graph with matching priors (tested equivalence)."""
    C = len(tokens)
    u = np.full((C, C), -np.log(C), np.float32)
    return BigramLm(
        tokens=list(tokens),
        pair_logp=u,
        init_logp=np.full(C, -np.log(C), np.float32),
        final_logp=np.zeros(C, np.float32),
    )

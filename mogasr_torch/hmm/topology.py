"""Monophone HMM topology: left-to-right HMMs with self-loops.

Maps phones to pdf (GMM/NN output state) ids and holds transition
log-probabilities (BASELINE.json configs[2]: "monophone GMM-HMM
forced-alignment"). Host-side; the jitted decoder consumes flat arrays built
by mogasr.hmm.graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from mogasr_torch.config import TopologyConfig
from mogasr_torch.hmm.lexicon import Lexicon


@dataclasses.dataclass(frozen=True)
class Topology:
    lexicon: Lexicon
    states_per_phone: int
    sil_states: int
    self_loop_logp: float
    advance_logp: float
    sil_self_loop_logp: float
    sil_advance_logp: float
    # optional per-phone self-loop probs from transition re-estimation
    # (em.estimate_transitions); overrides the two class-level defaults
    per_phone_self_prob: Tuple[float, ...] = ()

    @property
    def n_pdfs(self) -> int:
        return self.sil_states + (self.lexicon.n_phones - 1) * self.states_per_phone

    def phone_n_states(self, phone_id: int) -> int:
        return self.sil_states if phone_id == self.lexicon.sil_id else self.states_per_phone

    def phone_pdf_ids(self, phone_id: int) -> List[int]:
        """pdf ids of a phone's HMM states. Layout: sil first, then phones."""
        if phone_id == self.lexicon.sil_id:
            return list(range(self.sil_states))
        # lexicon guarantees sil is phone 0
        base = self.sil_states + (phone_id - 1) * self.states_per_phone
        return list(range(base, base + self.states_per_phone))

    def phone_trans_logps(self, phone_id: int) -> Tuple[float, float]:
        """(self_loop, advance) log-probs for a phone's states."""
        if self.per_phone_self_prob:
            p = min(max(self.per_phone_self_prob[phone_id], 1e-4), 1 - 1e-4)
            return float(np.log(p)), float(np.log1p(-p))
        if phone_id == self.lexicon.sil_id:
            return self.sil_self_loop_logp, self.sil_advance_logp
        return self.self_loop_logp, self.advance_logp

    def with_transitions(self, per_phone_self_prob: np.ndarray) -> "Topology":
        """Topology with re-estimated per-phone self-loop probabilities."""
        return dataclasses.replace(
            self, per_phone_self_prob=tuple(float(p) for p in per_phone_self_prob)
        )

    def pdf_to_phone(self) -> np.ndarray:
        """[n_pdfs] phone id for each pdf."""
        out = np.zeros(self.n_pdfs, np.int32)
        for p in range(self.lexicon.n_phones):
            for j in self.phone_pdf_ids(p):
                out[j] = p
        return out


def build_topology(lexicon: Lexicon, cfg: TopologyConfig) -> Topology:
    return Topology(
        lexicon=lexicon,
        states_per_phone=cfg.states_per_phone,
        sil_states=cfg.sil_states,
        self_loop_logp=float(np.log(cfg.self_loop_prob)),
        advance_logp=float(np.log1p(-cfg.self_loop_prob)),
        sil_self_loop_logp=float(np.log(cfg.sil_self_loop_prob)),
        sil_advance_logp=float(np.log1p(-cfg.sil_self_loop_prob)),
    )

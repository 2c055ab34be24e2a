"""Load a trained-system bundle (``gmm.npz`` + ``system.json``) for the port.

Mirrors ``mogasr.utils.bundle.load_system``. The lexicon, topology and
tied-triphone objects are the port's copies of the reference's numpy classes
(``mogasr_torch.hmm``); the GMM becomes tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mogasr_torch.config import FrontendConfig
from mogasr_torch.hmm.lexicon import make_lexicon
from mogasr_torch.hmm.topology import Topology
from mogasr_torch.hmm.triphone import TiedTriphones
from mogasr_torch.am.gmm import gmm_from_numpy

_FORMAT_VERSION = 1


def load_system(path: str, device: torch.device):
    """Load a bundle -> (gmm, topo, fcfg, tied_or_None, meta); gmm on ``device``."""
    with open(os.path.join(path, "system.json")) as f:
        doc = json.load(f)
    if doc.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"unknown bundle format {doc.get('format_version')!r}")

    with np.load(os.path.join(path, "gmm.npz")) as z:
        gmm = gmm_from_numpy(z["weights"], z["means"], z["vars"], device)

    lx = doc["lexicon"]
    lex = make_lexicon(dict(lx["prons"]), extra_phones=lx["phones"])
    if tuple(lex.phones) != tuple(lx["phones"]):
        raise ValueError(
            "phone inventory mismatch on load — pdf ids would be scrambled: "
            f"{lex.phones} vs {lx['phones']}"
        )
    if lx.get("variants"):
        lex = dataclasses.replace(
            lex,
            variants={w: tuple(tuple(v) for v in vs) for w, vs in lx["variants"].items()},
        )
    t = doc["topology"]
    topo = Topology(
        lexicon=lex,
        states_per_phone=t["states_per_phone"],
        sil_states=t["sil_states"],
        self_loop_logp=t["self_loop_logp"],
        advance_logp=t["advance_logp"],
        sil_self_loop_logp=t["sil_self_loop_logp"],
        sil_advance_logp=t["sil_advance_logp"],
        per_phone_self_prob=tuple(t["per_phone_self_prob"]),
    )
    tied = None
    if doc.get("tied"):
        td = doc["tied"]
        tied = TiedTriphones(
            topo=topo,
            tying={(l, c, r, k): pdf for l, c, r, k, pdf in td["tying"]},
            backoff={(c, k): pdf for c, k, pdf in td["backoff"]},
            n_pdfs=td["n_pdfs"],
        )
    fcfg = FrontendConfig(**doc["frontend"])
    return gmm, topo, fcfg, tied, doc.get("meta", {})

"""Train the headline-scale tied-triphone system on the card and export it as
a bundle: the twin of the reference's benchmarks/train_headline.py.

    python -m mogasr_torch.recipes.train_headline --out DIR [--train-utts N] [--device cpu] ...

The same arguments, defaults, corpus and stages as the reference: the v2
synthetic corpus (training seed 100, held-out seed 999, 3-9 words), a
monophone stage (EM with mixture splitting and transition re-estimation),
then tying to at most ``--target-pdfs`` tied pdfs and CD EM to
``--components`` components; the held-out WER of both through the decode
path; the bundle (utils/bundle.py format, which both packages read) with the
reference's ``meta`` keys, ``wall_s`` measured here with the card
synchronised. ``--out`` is required: the repo's benchmarks/headline bundle
is an input and is never written. Prints each stage's time and, last, the
meta JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import torch

from mogasr_torch import pipeline as pipe
from mogasr_torch.cli.common import device_of
from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr_torch.data import synthetic as syn
from mogasr_torch.eval.wer import corpus_wer
from mogasr_torch.hmm import triphone as tri
from mogasr_torch.hmm.lexicon import make_lexicon
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.utils.bundle import save_system
from mogasr_torch.utils.metrics import device_fence

TRAIN_SEED, TEST_SEED = 100, 999
BUCKETS = (250, 400, 550, 700)
BATCH = 32


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--train-utts", type=int, default=1600)
    p.add_argument("--test-utts", type=int, default=120)
    p.add_argument("--vocab", type=int, default=300)
    p.add_argument("--speakers", type=int, default=20)
    p.add_argument("--target-pdfs", type=int, default=1200)
    p.add_argument("--components", type=int, default=16)
    p.add_argument("--mono-components", type=int, default=8)
    p.add_argument("--mono-iters", type=int, default=10)
    p.add_argument("--cd-iters", type=int, default=12)
    p.add_argument("--min-occ", type=float, default=100.0,
                   help="min frames for a tied pdf (tying threshold)")
    p.add_argument("--min-split-occ", type=float, default=40.0,
                   help="min avg frames/component required to split a state")
    p.add_argument("--var-floor", type=float, default=0.01,
                   help="variance floor (features are CMVN unit-variance)")
    p.add_argument("--out", required=True, help="bundle dir to write")
    return p.parse_args(argv)


def run(args: argparse.Namespace, device: torch.device, log=print) -> Dict[str, Any]:
    """Both stages and the held-out WERs -> a dict: ``meta`` (the bundle's),
    the models (``gmm_mono``, ``topo``, ``tied``, ``gmm_cd``), the stage
    results (``mono``, ``cd``: TrainGmmResult with per-iteration and setup
    seconds), the batches (``train``, ``test``) and ``seconds`` per stage."""
    t0 = time.time()
    seconds: Dict[str, float] = {}

    def mark(name: str, since: float) -> float:
        device_fence()
        now = time.time()
        seconds[name] = now - since
        return now

    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=BATCH, bucket_boundaries=BUCKETS)
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)

    word_lex = syn.extended_lexicon(args.vocab)
    lex = make_lexicon(word_lex)
    topo = build_topology(lex, TopologyConfig())
    speakers = syn.make_speakers(args.speakers)
    style = syn.CorpusStyle()

    log(f"[{time.time() - t0:.0f}s] synthesizing {args.train_utts}+{args.test_utts} utts")
    train = syn.make_corpus_v2(args.train_utts, lexicon=word_lex, speakers=speakers, style=style,
                               seed=TRAIN_SEED, words_per_utt=(3, 9))
    test = syn.make_corpus_v2(args.test_utts, lexicon=word_lex, speakers=speakers, style=style,
                              seed=TEST_SEED, words_per_utt=(3, 9))
    t = mark("synthesize", t0)

    log(f"[{time.time() - t0:.0f}s] featurizing")
    tb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in train], fcfg, bcfg, device)
    eb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in test], fcfg, bcfg, device)
    n_frames_total = sum(int(x) for fb in tb for x in fb.n_frames)
    t = mark("featurize", t)
    log(f"[{time.time() - t0:.0f}s] {n_frames_total} train frames")

    # ---- stage 1: monophone EM with splitting + transition re-estimation
    gcfg_mono = GmmConfig(n_states=topo.n_pdfs, n_components=args.mono_components, feat_dim=fcfg.feat_dim,
                          var_floor=args.var_floor, min_split_occ=args.min_split_occ)
    res = pipe.train_gmm(tb, lex, topo, gcfg_mono, TrainConfig(num_em_iters=args.mono_iters),
                         reestimate_transitions=True)
    gmm_mono, topo_t = res.gmm, res.topo
    t = mark("mono_em", t)
    log(f"[{time.time() - t0:.0f}s] mono EM done: loglik {res.history[0]:.2f} -> {res.history[-1]:.2f}")

    m_mono = pipe.evaluate(eb, gmm_mono, lex, topo_t, dcfg)
    t = mark("mono_eval", t)
    log(f"[{time.time() - t0:.0f}s] mono heldout WER {m_mono['wer']:.4f}")

    # ---- stage 2: tied-triphone system at headline scale
    gcfg_cd = GmmConfig(n_states=args.target_pdfs, n_components=args.components, feat_dim=fcfg.feat_dim,
                        var_floor=args.var_floor, min_split_occ=args.min_split_occ)
    tied, res_cd = pipe.train_triphone(tb, lex, topo_t, gcfg_cd, TrainConfig(num_em_iters=args.cd_iters),
                                       gmm_mono, target_pdfs=args.target_pdfs, min_occ=args.min_occ)
    gmm_cd = res_cd.gmm
    t = mark("cd", t)
    log(f"[{time.time() - t0:.0f}s] CD EM done: {tied.n_pdfs} tied pdfs x {gmm_cd.n_components} comps, "
        f"loglik {res_cd.history[0]:.2f} -> {res_cd.history[-1]:.2f}")

    # ---- held-out WER of the exact exported system (the CD word loop)
    graph_cd = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    refs, hyps = [], []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm_cd)
        out = pipe.decode_batch(fb, scores, graph_cd, dcfg)
        for b in range(fb.size):
            refs.append([w.lower() for w in fb.words[b]])
            hyps.append([w.lower() for w in out[b]])
    wer_cd, detail = corpus_wer(refs, hyps)
    mark("cd_eval", t)
    log(f"[{time.time() - t0:.0f}s] CD heldout WER {wer_cd:.4f} ({detail})")

    meta = {
        "corpus": "v2",
        "train_utts": args.train_utts,
        "test_utts": args.test_utts,
        "vocab": args.vocab,
        "speakers": args.speakers,
        "train_frames": n_frames_total,
        "tied_pdfs": tied.n_pdfs,
        "components": gmm_cd.n_components,
        "min_occ": args.min_occ,
        "min_split_occ": args.min_split_occ,
        "var_floor": args.var_floor,
        "em_loglik_mono": [round(h, 4) for h in res.history],
        "em_loglik_cd": [round(h, 4) for h in res_cd.history],
        "heldout_wer_mono": round(m_mono["wer"], 4),
        "heldout_wer": round(wer_cd, 4),
        "decode": {"acoustic_scale": dcfg.acoustic_scale,
                   "word_insertion_penalty": dcfg.word_insertion_penalty},
        "wall_s": round(time.time() - t0, 1),
    }
    return {"meta": meta, "gmm_mono": gmm_mono, "topo": topo_t, "tied": tied, "gmm_cd": gmm_cd, "fcfg": fcfg,
            "dcfg": dcfg, "mono": res, "cd": res_cd, "train": tb, "test": eb, "seconds": seconds,
            "heldout_wer_mono": m_mono["wer"], "heldout_wer": wer_cd}


def stage_report(out: Dict[str, Any]) -> str:
    """Each stage's seconds, the setup and per-iteration seconds of the two
    EM stages with their split over ``pipeline.TRAIN_STAGES``."""
    lines = ["stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items())]
    for name in ("mono", "cd"):
        r = out[name]
        lines.append(f"{name} setup seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in r.setup_seconds.items()))
        for i, (s, st) in enumerate(zip(r.seconds, r.stage_seconds)):
            lines.append(f"{name} iter {i}: {s:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in st.items()) + ")")
    return "\n".join(lines)


def main(argv=None, log=print) -> Optional[Dict[str, Any]]:
    args = parse_args(argv)
    out = run(args, device_of("cpu" if args.cpu else args.device), log=log)
    save_system(args.out, out["gmm_cd"], out["topo"], out["fcfg"], tied=out["tied"], meta=out["meta"])
    log(stage_report(out))
    log(f"saved bundle to {args.out}")
    print(json.dumps(out["meta"], indent=2))
    return out


if __name__ == "__main__":
    main()

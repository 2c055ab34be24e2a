"""GMM-HMM training on the card: the twin of the reference's cli/train_gmm.py.

    python -m mogasr_torch.cli.train_gmm --synthetic-v2 200 --run-dir runs/gmm \
        [--triphones N_PDFS] [--mmi ITERS] [--smbr ITERS] [--lda CONTEXT [--lda-dim N]] [--bundle-out DIR] \
        [--device cpu]

featurize -> flat start -> ML EM with mixture splitting (Viterbi or
Baum-Welch), checkpointed after every iteration under <run-dir>/em_ckpt and
resumed from there when the run is started again -> optional MMI and sMBR
refinement -> the GMM checkpoint <run-dir>/gmm -> optional splice -> LDA
-> MLLT system (``pipeline.train_lda_mllt``, booted from that GMM;
<run-dir>/gmm_lda holds its GMM with ``lda_transform`` and ``lda_context``)
-> optional tied-triphone system (<run-dir>/gmm_cd) -> optional deployable
bundle (utils/bundle.py), which both packages' ``load_system`` read. The
checkpoints are the port's format (``utils/checkpoint.py``). Records go to
<run-dir>/metrics.jsonl. Runs on ``--device`` (default cuda).

``--add-pitch`` appends the pitch triple (``frontend/pitch.py``) to the
features.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mogasr_torch.cli.common import (
    add_augment_args, add_corpus_args, add_run_args, apply_augmentation, device_of, load_corpus, make_logger,
)
from mogasr_torch.config import BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import featurize, train_gmm
from mogasr_torch.utils.checkpoint import save_checkpoint
from mogasr_torch.utils.metrics import Timer, trace


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features")
    add_corpus_args(p)
    add_run_args(p)
    add_augment_args(p)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--mode", default="viterbi", choices=["viterbi", "baum-welch"],
                   help="hard (Viterbi) EM or full Baum-Welch soft EM")
    p.add_argument("--triphones", type=int, default=0, metavar="N_PDFS",
                   help="after monophone training, build a tied-triphone "
                        "system with ~N_PDFS states and run CD EM")
    p.add_argument("--mmi", type=int, default=0, metavar="ITERS",
                   help="discriminative MMI refinement iterations after ML "
                        "training (dense denominator, extended Baum-Welch)")
    p.add_argument("--smbr", type=int, default=0, metavar="ITERS",
                   help="discriminative sMBR refinement iterations after ML "
                        "training (expected frame accuracy, I-smoothed EBW)")
    p.add_argument("--disc-acoustic-scale", type=float, default=0.1,
                   help="acoustic scale (kappa) for --mmi/--smbr")
    p.add_argument("--bundle-out", metavar="DIR",
                   help="export the trained system (GMM + lexicon + topology "
                        "[+ tied triphones] + frontend config) as a bundle dir")
    p.add_argument("--lda", type=int, default=0, metavar="CONTEXT",
                   help="also train a splice(+-CONTEXT)->LDA->MLLT system booted from the ML GMM; saved to "
                        "<run-dir>/gmm_lda with its transform")
    p.add_argument("--lda-dim", type=int, default=40, help="LDA projection dimension (with --lda)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    corpus, lex = load_corpus(args)
    corpus = apply_augmentation(corpus, args)
    fcfg = FrontendConfig(add_pitch=args.add_pitch)
    topo = build_topology(lex, TopologyConfig())
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=args.num_components, feat_dim=fcfg.feat_dim)
    tcfg = TrainConfig(num_em_iters=args.num_iters)
    logger = make_logger(args)
    run_dir = os.path.abspath(args.run_dir)

    with trace(os.path.join(run_dir, "profile") if args.profile else None):
        with Timer() as t:
            batches = featurize(corpus, fcfg, BatchConfig(), device)
            gmm, history = train_gmm(batches, lex, topo, gcfg, tcfg, logger=logger, mode=args.mode,
                                     ckpt_dir=os.path.join(run_dir, "em_ckpt"))
        logger.log({
            "stage": "train_gmm_done", "iters": len(history), "final_avg_loglik": history[-1],
            "wall_sec": t.seconds, "K": gmm.n_components, "S": gmm.n_states,
        })
        if args.mmi > 0:
            from mogasr_torch.am.mmi import train_mmi

            with Timer() as tm:
                gmm, mmi_hist = train_mmi(batches, lex, topo, gmm, n_iters=args.mmi,
                                          acoustic_scale=args.disc_acoustic_scale, logger=logger)
            logger.log({
                "stage": "train_mmi_done", "iters": len(mmi_hist), "criterion_first": mmi_hist[0],
                "criterion_last": mmi_hist[-1], "wall_sec": tm.seconds,
            })
        if args.smbr > 0:
            from mogasr_torch.am.smbr import train_smbr

            with Timer() as ts:
                gmm, smbr_hist = train_smbr(batches, lex, topo, gmm, n_iters=args.smbr,
                                            acoustic_scale=args.disc_acoustic_scale, logger=logger)
            logger.log({
                "stage": "train_smbr_done", "iters": len(smbr_hist), "expected_acc_first": smbr_hist[0],
                "expected_acc_last": smbr_hist[-1], "wall_sec": ts.seconds,
            })

        ckpt = os.path.join(run_dir, "gmm")
        save_checkpoint(ckpt, gmm._asdict(), step=len(history))
        print(f"saved GMM ({gmm.n_states} states x {gmm.n_components} comps) to {ckpt}")

        if args.lda > 0:
            from mogasr_torch.pipeline import train_lda_mllt

            with Timer() as tl:
                sys_lda = train_lda_mllt(corpus, lex, topo, fcfg, BatchConfig(), gcfg, tcfg, gmm, context=args.lda,
                                         lda_dim=args.lda_dim, logger=logger, mode=args.mode)
            logger.log({
                "stage": "train_lda_mllt_done", "context": args.lda, "lda_dim": args.lda_dim,
                "final_avg_loglik": sys_lda.history[-1], "wall_sec": tl.seconds,
            })
            lda_ckpt = os.path.join(run_dir, "gmm_lda")
            save_checkpoint(lda_ckpt, {**sys_lda.gmm._asdict(), "lda_transform": np.asarray(sys_lda.transform),
                                       "lda_context": np.asarray([args.lda], np.int32)}, step=len(sys_lda.history))
            print(f"saved LDA+MLLT GMM ({args.lda_dim}-dim, context +-{args.lda}) to {lda_ckpt}")

        if args.triphones > 0:
            from mogasr_torch.pipeline import train_triphone

            with Timer() as t2:
                tied, res = train_triphone(batches, lex, topo, gcfg, tcfg, gmm, target_pdfs=args.triphones,
                                           logger=logger, mode=args.mode)
            logger.log({
                "stage": "train_cd_done", "tied_pdfs": tied.n_pdfs, "final_avg_loglik": res.history[-1],
                "wall_sec": t2.seconds,
            })
            cd_ckpt = os.path.join(run_dir, "gmm_cd")
            save_checkpoint(cd_ckpt, res.gmm._asdict(), step=len(res.history))
            print(f"saved CD GMM ({tied.n_pdfs} tied pdfs) to {cd_ckpt}")

    if args.bundle_out:
        from mogasr_torch.utils.bundle import save_system

        if args.triphones > 0:
            save_system(args.bundle_out, res.gmm, topo, fcfg, tied=tied,
                        meta={"source": "mogasr_torch/cli/train_gmm.py", "final_avg_loglik": res.history[-1]})
        else:
            save_system(args.bundle_out, gmm, topo, fcfg,
                        meta={"source": "mogasr_torch/cli/train_gmm.py", "final_avg_loglik": history[-1]})
        print(f"wrote deployable bundle to {args.bundle_out}")


if __name__ == "__main__":
    main()

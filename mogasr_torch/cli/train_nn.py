"""Neural acoustic-model training on the card: the twin of the reference's
cli/train_nn.py.

    python -m mogasr_torch.cli.train_nn --synthetic-v2 200 --arch lstm --hidden 512 --layers 3 --steps 500 \\
        --run-dir runs/nn [--spec-augment] [--ivector-dim R] [--seq-mmi-steps N] [--seq-smbr-steps N] \\
        [--save-every N --average-last K] [--device cpu]

``--objective ce`` (the hybrid NN-HMM): featurize -> a GMM bootstrap
(``--bootstrap-iters`` EM iterations, ``--bootstrap-components``; K1 and
K2) -> forced alignment of every batch (K1 float32/sum, K2's chain arm) as
the frame labels and the state priors -> optionally an i-vector extractor
whose i-vectors are appended to every frame (saved to
<run-dir>/ivector_extractor) -> frame-CE training of ``--arch`` (mlp, lstm,
blstm, tdnn, conformer, moe; ``am.train_nn``: AdamW under the reference's
schedule, ``--spec-augment`` masking) -> optionally MMI and then sMBR
fine-tuning (``am.nn_seq``: K3 through its autograd Functions, priors
frozen) -> the checkpoint <run-dir>/nn_<arch>, ``{"params": the model's
state_dict, "log_priors"}`` in the port's checkpoint format, saved at the
reference's step numbers (every ``--save-every`` steps, the fine-tuned
model as step steps + 1 when the CE loop already wrote step steps, and with
``--average-last K`` the average of the last K steps as the newest).
``--objective mpc``: masked-predictive-coding pretraining of the ``--arch``
encoder (``am.pretrain``, no transcripts read), saved to
<run-dir>/nn_mpc_<arch> as ``{"params": state_dict}``. Decode a CE model
with ``decode``/``eval --am <arch> --nn-ckpt <run-dir>/nn_<arch>`` (and the
same ``--nn-hidden/--nn-layers/--nn-experts``).

``--objective ctc``: alignment-free CTC over the transcripts' phones (or
``--bpe-merges N`` BPE units learned from them, ``bpe.json`` written to the
run dir), no GMM bootstrap (``pipeline.train_ctc``/``train_ctc_bpe``: the
loss on kernel K3); ``--init-from <run-dir>/nn_mpc_<arch>`` warm-starts the
encoder from an MPC checkpoint of the same sizes; ``--distill-from DIR``
trains the ``--arch`` student on a CTC teacher's frame posteriors
(``pipeline.distill_ctc_units``; the teacher's ``--distill-teacher-*`` sizes
as it was trained, its ``bpe.json`` reused when one is next to it). The
checkpoint is <run-dir>/nn_ctc_<arch>, ``{"params": state_dict}``; decode it
with ``decode``/``search``/``transcribe --ctc``, ``eval``/``decode
--ctc --bpe``, ``stream --ctc`` (LstmAm).

``--objective rnnt`` (``--arch lstm|blstm``, the encoder): the RNN-T over the
transcripts' phones or ``--bpe-merges`` BPE units (``pipeline.train_rnnt`` /
``train_rnnt_bpe``: a stateless prediction net and the auxiliary CTC head,
its loss on K3), ``--rnnt-pruned-band S`` with the pruned loss
(``am.rnnt_pruned``; decode with ``--rnnt-pruned``), ``--mwer-steps N``
then N steps of on-policy MWER (``pipeline.finetune_rnnt_mwer``, the device
beam's 4-best). The checkpoint is <run-dir>/nn_rnnt_<arch>, ``{"params":
state_dict}``; decode it with ``decode``/``eval``/``transcribe``/``stream``
/``serve --rnnt``.

LstmAm and BlstmAm train on their plain recurrence under autograd (kernel
K4 has no backward, as the reference's Pallas kernel trains nothing) and
decode on K4. Records go to <run-dir>/metrics.jsonl. Runs on ``--device``
(default cuda).

``--objective aed``: the attention encoder-decoder (``am.aed``: a
Conformer encoder of ``--layers`` blocks at d_model ``--hidden``, a
Transformer decoder, the auxiliary CTC loss on K3) over the transcripts'
phones or ``--bpe-merges`` BPE units (``pipeline.train_aed`` /
``train_aed_bpe``; ``--spec-augment``), ``--aed-chunk C --aed-left-chunks
L`` for the streaming-capable chunked encoder, ``--mwer-steps N`` then N
steps of on-policy MWER (``pipeline.finetune_aed_mwer``, the beam's 4-best).
``--arch`` only names the checkpoint, <run-dir>/nn_aed_<arch>, ``{"params":
state_dict}``; decode it with ``decode``/``eval``/``transcribe --aed`` and
a chunked one with ``stream``/``serve --aed``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mogasr_torch.cli.common import (
    add_augment_args, add_corpus_args, add_run_args, apply_augmentation, device_of, load_corpus, make_logger,
)
from mogasr_torch.config import BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr_torch.hmm.topology import build_topology
from mogasr_torch.pipeline import align_batch, featurize, train_gmm
from mogasr_torch.utils.checkpoint import save_checkpoint
from mogasr_torch.utils.metrics import Timer, trace

ARCHS = ["mlp", "lstm", "blstm", "tdnn", "conformer", "moe"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the pitch triple (POV, centered log-f0, delta log-f0) to the features; must match "
                        "between training and decoding")
    add_corpus_args(p)
    add_run_args(p)
    add_augment_args(p)
    p.add_argument("--arch", default="mlp", choices=ARCHS)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--experts", type=int, default=4,
                   help="with --arch moe: number of top-1-routed FFN experts (decode with --am moe --nn-experts)")
    p.add_argument("--steps", type=int, default=500)  # must be >= 1
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--spec-augment", action="store_true", help="SpecAugment time/feature masking during training")
    p.add_argument("--objective", default="ce", choices=["ce", "ctc", "rnnt", "aed", "mpc"],
                   help="ce: frame CE on GMM forced alignments; ctc: alignment-free CTC on transcript phone (or "
                        "--bpe-merges) targets; mpc: unsupervised masked-predictive-coding pretraining of the "
                        "--arch encoder (no transcripts read); rnnt: RNN-transducer (--arch lstm/blstm encoder, "
                        "stateless prediction net, auxiliary CTC); aed: attention encoder-decoder (Conformer + "
                        "Transformer decoder, joint CTC)")
    p.add_argument("--bpe-merges", type=int, default=0, metavar="N",
                   help="with --objective ctc/rnnt/aed: train on BPE subword units (N merges learned from the "
                        "transcripts) instead of phones; writes bpe.json into the run dir")
    p.add_argument("--init-from", metavar="CKPT_DIR",
                   help="with --objective ctc: warm-start the encoder from an MPC checkpoint (train_nn --objective "
                        "mpc with the same --arch/--hidden/--layers); the CTC head keeps its fresh weights")
    p.add_argument("--distill-from", metavar="CKPT_DIR",
                   help="with --objective ctc: distil a trained CTC teacher checkpoint's frame posteriors into this "
                        "(student) model; the teacher's units are reused (bpe.json next to it, else phones)")
    p.add_argument("--distill-teacher-arch", default="conformer", choices=["mlp", "lstm", "blstm", "tdnn", "conformer"],
                   help="teacher architecture: must match the checkpoint")
    p.add_argument("--distill-teacher-hidden", type=int, default=512)
    p.add_argument("--distill-teacher-layers", type=int, default=3)
    p.add_argument("--distill-alpha", type=float, default=0.5, help="soft-target weight: alpha*KL + (1-alpha)*CTC")
    p.add_argument("--distill-temp", type=float, default=2.0, help="distillation softmax temperature")
    p.add_argument("--aed-chunk", type=int, default=0, metavar="C",
                   help="with --objective aed: train the streaming-capable chunked encoder (C subsampled frames a "
                        "chunk, causal convolutions; stream with stream/serve --aed)")
    p.add_argument("--aed-left-chunks", type=int, default=1,
                   help="with --aed-chunk: left-context chunks each chunk attends to")
    p.add_argument("--rnnt-pruned-band", type=int, default=0, metavar="S",
                   help="with --objective rnnt: the pruned transducer loss (am.rnnt_pruned), the joint evaluated "
                        "on a band of S label positions a frame; the checkpoint gains the simple heads (decode "
                        "with --rnnt-pruned)")
    p.add_argument("--mwer-steps", type=int, default=0, metavar="N",
                   help="with --objective aed/rnnt: N steps of on-policy MWER fine-tuning after training")
    p.add_argument("--ivector-dim", type=int, default=0, metavar="R",
                   help="CE path: train an i-vector extractor (UBM + total variability) on the training features "
                        "and append per-utterance i-vectors to every frame (decode with --ivector-ckpt "
                        "RUN_DIR/ivector_extractor)")
    p.add_argument("--ivector-components", type=int, default=64)
    p.add_argument("--seq-mmi-steps", type=int, default=0, metavar="N",
                   help="CE path: N steps of MMI fine-tuning after CE (alignment numerator, word-loop "
                        "denominator, priors frozen; am.nn_seq)")
    p.add_argument("--seq-mmi-scale", type=float, default=0.1, help="MMI/sMBR acoustic scale (kappa)")
    p.add_argument("--seq-smbr-steps", type=int, default=0, metavar="N",
                   help="CE path: N steps of sMBR fine-tuning after CE (and after --seq-mmi-steps), the CE labels "
                        "as reference (am.nn_seq)")
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="checkpoint every N steps (CE path); enables --average-last")
    p.add_argument("--average-last", type=int, default=0, metavar="K",
                   help="after training, save the uniform average of the last K checkpoints as the newest step")
    p.add_argument("--bootstrap-iters", type=int, default=6, help="EM iterations for the GMM that produces labels")
    p.add_argument("--bootstrap-components", type=int, default=4)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    if args.arch == "moe" and args.objective != "ce":
        raise SystemExit("--arch moe supports --objective ce (the hybrid CE path collects the MoE load-balance "
                         "aux loss; the other objectives would drop it)")
    if args.init_from and args.objective != "ctc":
        raise SystemExit("--init-from (MPC warm start) supports --objective ctc")
    if args.distill_from and args.objective != "ctc":
        raise SystemExit("--distill-from supports --objective ctc")
    if args.distill_from and args.bpe_merges > 0:
        raise SystemExit("--distill-from reuses the TEACHER's unit inventory (its bpe.json): drop --bpe-merges")
    if args.objective == "rnnt" and args.arch not in ("lstm", "blstm"):
        raise SystemExit("--objective rnnt needs --arch lstm/blstm")
    device = device_of(args.device)
    corpus, lex = load_corpus(args)
    corpus = apply_augmentation(corpus, args)
    fcfg = FrontendConfig(add_pitch=args.add_pitch)
    topo = build_topology(lex, TopologyConfig())
    logger = make_logger(args)
    run_dir = os.path.abspath(args.run_dir)
    with trace(os.path.join(run_dir, "profile") if args.profile else None):
        batches = featurize(corpus, fcfg, BatchConfig(), device)
        if args.objective == "mpc":
            _pretrain(args, batches, logger, run_dir)
        elif args.objective == "ctc":
            _train_ctc(args, batches, lex, fcfg, logger, run_dir, device)
        elif args.objective == "rnnt":
            _train_rnnt(args, batches, lex, logger, run_dir)
        elif args.objective == "aed":
            _train_aed(args, batches, lex, logger, run_dir)
        else:
            _train_ce(args, batches, lex, topo, fcfg, logger, run_dir, device)


def _pretrain(args, batches, logger, run_dir: str) -> None:
    from mogasr_torch.am.pretrain import pretrain_mpc

    tcfg = TrainConfig(nn_arch=args.arch, nn_hidden=args.hidden, nn_layers=args.layers, lr=args.lr,
                       num_nn_steps=args.steps)
    with Timer() as t:
        model, _sd = pretrain_mpc(batches, tcfg, arch=args.arch, logger=logger)
    logger.log({"stage": "train_mpc_done", "steps": args.steps, "wall_sec": t.seconds})
    ckpt = os.path.join(run_dir, f"nn_mpc_{args.arch}")
    save_checkpoint(ckpt, {"params": model.state_dict()}, step=args.steps)
    print(f"saved MPC {args.arch} AM to {ckpt}")


def _train_ctc(args, batches, lex, fcfg, logger, run_dir: str, device: torch.device) -> None:
    from mogasr_torch.pipeline import distill_ctc_units, train_ctc, train_ctc_bpe

    tcfg = TrainConfig(nn_arch=args.arch, nn_hidden=args.hidden, nn_layers=args.layers, lr=args.lr,
                       num_nn_steps=args.steps)
    init_params = None
    if args.init_from:
        from mogasr_torch.utils.checkpoint import restore_checkpoint

        init_params = {k: torch.as_tensor(v) for k, v in
                       restore_checkpoint(os.path.abspath(args.init_from))["params"].items()}
    with Timer() as t:
        if args.distill_from:
            from mogasr_torch.am.ctc import ctc_labels_from_words
            from mogasr_torch.cli.common import load_ctc_model

            teacher_dir = os.path.abspath(args.distill_from)
            bpe_path = os.path.join(os.path.dirname(teacher_dir), "bpe.json")
            if os.path.exists(bpe_path):
                from mogasr_torch.data.bpe import load_bpe, save_bpe

                bpe = load_bpe(bpe_path)
                encode_fn, n_units = bpe.encode, bpe.n_units
                save_bpe(bpe, os.path.join(run_dir, "bpe.json"))  # the student decodes with the same units
            else:
                def encode_fn(words):
                    return ctc_labels_from_words(lex, words, include_sil=False)

                n_units = lex.n_phones
            teacher = load_ctc_model(args.distill_teacher_arch, n_units, args.distill_teacher_hidden,
                                     args.distill_teacher_layers, int(batches[0].feats.shape[-1]), teacher_dir,
                                     device)
            model, _sd = distill_ctc_units(batches, teacher, encode_fn, n_units, tcfg, student_arch=args.arch,
                                           alpha=args.distill_alpha, temperature=args.distill_temp,
                                           spec_augment=args.spec_augment, logger=logger)
        elif args.bpe_merges > 0:
            from mogasr_torch.data.bpe import save_bpe, train_bpe

            bpe = train_bpe([fb.words[b] for fb in batches for b in range(fb.size)], n_merges=args.bpe_merges)
            save_bpe(bpe, os.path.join(run_dir, "bpe.json"))
            model, _sd = train_ctc_bpe(batches, bpe, tcfg, arch=args.arch, spec_augment=args.spec_augment,
                                       logger=logger)
        else:
            model, _sd = train_ctc(batches, lex, tcfg, arch=args.arch, spec_augment=args.spec_augment,
                                   init_params=init_params, logger=logger)
    logger.log({"stage": "train_ctc_done", "steps": args.steps, "wall_sec": t.seconds})
    ckpt = os.path.join(run_dir, f"nn_ctc_{args.arch}")
    save_checkpoint(ckpt, {"params": model.state_dict()}, step=args.steps)
    print(f"saved CTC {args.arch} AM to {ckpt}")


def _train_rnnt(args, batches, lex, logger, run_dir: str) -> None:
    from mogasr_torch.am.ctc import ctc_labels_from_words
    from mogasr_torch.pipeline import finetune_rnnt_mwer, train_rnnt, train_rnnt_bpe

    tcfg = TrainConfig(nn_arch=args.arch, nn_hidden=args.hidden, nn_layers=args.layers, lr=args.lr,
                       num_nn_steps=args.steps)
    with Timer() as t:
        if args.bpe_merges > 0:
            from mogasr_torch.data.bpe import save_bpe, train_bpe

            bpe = train_bpe([fb.words[b] for fb in batches for b in range(fb.size)], n_merges=args.bpe_merges)
            save_bpe(bpe, os.path.join(run_dir, "bpe.json"))
            encode_fn = bpe.encode
            model, _sd = train_rnnt_bpe(batches, bpe, tcfg, encoder_arch=args.arch,
                                        pruned_band=args.rnnt_pruned_band, logger=logger)
        else:
            def encode_fn(words):
                return ctc_labels_from_words(lex, words, include_sil=False)

            model, _sd = train_rnnt(batches, lex, tcfg, encoder_arch=args.arch, pruned_band=args.rnnt_pruned_band,
                                    logger=logger)
    if args.mwer_steps > 0:
        _sd, mwer_hist = finetune_rnnt_mwer(model, batches, encode_fn, tcfg, steps=args.mwer_steps, logger=logger)
        logger.log({"stage": "mwer_done", "steps": args.mwer_steps, "expected_risk_first": mwer_hist[0],
                    "expected_risk_last": mwer_hist[-1]})
    logger.log({"stage": "train_rnnt_done", "steps": args.steps, "wall_sec": t.seconds})
    ckpt = os.path.join(run_dir, f"nn_rnnt_{args.arch}")
    save_checkpoint(ckpt, {"params": model.state_dict()}, step=args.steps)
    print(f"saved RNNT {args.arch} AM to {ckpt}")


def _train_aed(args, batches, lex, logger, run_dir: str) -> None:
    from mogasr_torch.am.ctc import ctc_labels_from_words
    from mogasr_torch.pipeline import finetune_aed_mwer, train_aed, train_aed_bpe

    tcfg = TrainConfig(nn_arch=args.arch, nn_hidden=args.hidden, nn_layers=args.layers, lr=args.lr,
                       num_nn_steps=args.steps)
    opts = dict(chunk_frames=args.aed_chunk, left_chunks=args.aed_left_chunks, spec_augment=args.spec_augment)
    with Timer() as t:
        if args.bpe_merges > 0:
            from mogasr_torch.data.bpe import save_bpe, train_bpe

            bpe = train_bpe([fb.words[b] for fb in batches for b in range(fb.size)], n_merges=args.bpe_merges)
            save_bpe(bpe, os.path.join(run_dir, "bpe.json"))
            encode_fn = bpe.encode
            model, _sd = train_aed_bpe(batches, bpe, tcfg, logger=logger, **opts)
        else:
            def encode_fn(words):
                return ctc_labels_from_words(lex, words, include_sil=False)

            model, _sd = train_aed(batches, lex, tcfg, logger=logger, **opts)
    if args.mwer_steps > 0:
        _sd, mwer_hist = finetune_aed_mwer(model, batches, encode_fn, tcfg, steps=args.mwer_steps, logger=logger)
        logger.log({"stage": "mwer_done", "steps": args.mwer_steps, "expected_risk_first": mwer_hist[0],
                    "expected_risk_last": mwer_hist[-1]})
    logger.log({"stage": "train_aed_done", "steps": args.steps, "wall_sec": t.seconds})
    ckpt = os.path.join(run_dir, f"nn_aed_{args.arch}")
    save_checkpoint(ckpt, {"params": model.state_dict()}, step=args.steps)
    print(f"saved AED {args.arch} AM to {ckpt}")


def _train_ce(args, batches, lex, topo, fcfg, logger, run_dir: str, device: torch.device) -> None:
    from mogasr_torch.am.neural import build_model, state_priors
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.train_nn import init_train_state, make_train_step

    # GMM bootstrap for the alignment labels
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=args.bootstrap_components, feat_dim=fcfg.feat_dim)
    gmm, _hist = train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=args.bootstrap_iters), logger=logger)
    labeled = [(fb, align_batch(fb, gmm, lex, topo)[1]) for fb in batches]
    all_labels = np.concatenate([labels.cpu().numpy().reshape(-1) for _fb, labels in labeled])
    log_priors = state_priors(all_labels, topo.n_pdfs)

    ivec_rank = 0
    if args.ivector_dim > 0:
        from mogasr_torch.am.ivector import save_extractor, train_ivector_extractor
        from mogasr_torch.pipeline import append_ivectors

        extractor = train_ivector_extractor(batches, n_components=args.ivector_components, rank=args.ivector_dim)
        aug = append_ivectors(batches, extractor)
        labeled = [(afb, labels) for afb, (_fb, labels) in zip(aug, labeled)]
        iv_ckpt = os.path.join(run_dir, "ivector_extractor")
        save_extractor(iv_ckpt, extractor)
        logger.log({"stage": "ivector_extractor", "components": args.ivector_components, "rank": args.ivector_dim,
                    "ckpt": iv_ckpt})
        ivec_rank = args.ivector_dim

    tcfg = TrainConfig(nn_arch=args.arch, nn_hidden=args.hidden, nn_layers=args.layers, nn_experts=args.experts,
                       lr=args.lr, num_nn_steps=args.steps)
    model = init_(build_model(args.arch, topo.n_pdfs, tcfg, fcfg.feat_dim + ivec_rank),
                  torch.Generator().manual_seed(tcfg.seed)).to(device)
    state = init_train_state(model, tcfg)
    step_fn = make_train_step(tcfg, spec_aug=args.spec_augment)
    ckpt = os.path.join(run_dir, f"nn_{args.arch}")

    def tree_of(m: torch.nn.Module) -> dict:
        return {"params": m.state_dict(), "log_priors": log_priors}

    with Timer() as t:
        i = 0
        while i < args.steps:
            for fb, labels in labeled:
                state, metrics = step_fn(state, fb.feats, fb.n_frames, labels)
                i += 1
                if i % 50 == 0:
                    logger.log({"stage": "train_nn", "step": i, "loss": metrics["loss"],
                                "frame_acc": metrics["frame_acc"]})
                if args.save_every > 0 and i % args.save_every == 0:
                    save_checkpoint(ckpt, tree_of(model), step=i)
                if i >= args.steps:
                    break
    logger.log({"stage": "train_nn_done", "steps": i, "wall_sec": t.seconds, "final_loss": metrics["loss"],
                "final_frame_acc": metrics["frame_acc"]})
    if args.seq_mmi_steps > 0:
        from mogasr_torch.am.nn_seq import finetune_nn_mmi

        _m, mmi_hist = finetune_nn_mmi([fb for fb, _labels in labeled], lex, topo, model, log_priors, tcfg,
                                       steps=args.seq_mmi_steps, acoustic_scale=args.seq_mmi_scale, logger=logger)
        logger.log({"stage": "nn_mmi_done", "steps": args.seq_mmi_steps, "mmi_per_frame_first": mmi_hist[0],
                    "mmi_per_frame_last": mmi_hist[-1]})
    if args.seq_smbr_steps > 0:
        from mogasr_torch.am.nn_seq import finetune_nn_smbr

        _m, smbr_hist = finetune_nn_smbr(labeled, lex, topo, model, log_priors, tcfg, steps=args.seq_smbr_steps,
                                         acoustic_scale=args.seq_mmi_scale, logger=logger)
        logger.log({"stage": "nn_smbr_done", "steps": args.seq_smbr_steps, "acc_per_frame_first": smbr_hist[0],
                    "acc_per_frame_last": smbr_hist[-1]})
    seq_tuned = args.seq_mmi_steps > 0 or args.seq_smbr_steps > 0
    saved_last = args.save_every > 0 and i % args.save_every == 0
    if seq_tuned and saved_last:
        # the CE loop wrote step i before the fine-tuning changed the model
        save_checkpoint(ckpt, tree_of(model), step=i + 1)
    elif seq_tuned or not saved_last:
        save_checkpoint(ckpt, tree_of(model), step=i)
    if args.average_last > 1:
        from mogasr_torch.utils.checkpoint import average_checkpoints

        save_checkpoint(ckpt, average_checkpoints(ckpt, last_k=args.average_last), step=i + 1)
        logger.log({"stage": "ckpt_average", "last_k": args.average_last, "saved_step": i + 1})
    print(f"saved {args.arch} AM to {ckpt}")


if __name__ == "__main__":
    main()

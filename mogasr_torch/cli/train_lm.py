"""Language-model training over corpus transcripts: the twin of the reference's
cli/train_lm.py.

    python -m mogasr_torch.cli.train_lm --synthetic 200 [--nnlm-arch lstm|transformer] [--hidden 128]
        [--layers 1] [--steps 500] [--lr 5e-3] [--batch-size 64] [--heldout-frac 0.1] [--run-dir DIR]
    python -m mogasr_torch.cli.train_lm --synthetic 200 --unit-ngram [--bpe runs/ctc/bpe.json] \\
        [--kn-discount 0.75] [--heldout-frac 0.1] [--run-dir DIR]

The default path trains the neural word LM (``lm.neural.train_nnlm``: an
LSTM, its no-grad forwards on kernel K4 on the card, or a causal
Transformer) on the transcripts but the last ``--heldout-frac``, on
``--device`` (default cuda); reports the held-out perplexity beside a
Kneser-Ney bigram's on the in-vocabulary held-out sentences; and writes
<run-dir>/nnlm (``lm.neural.save_nnlm``, the port's checkpoint format) for
``decode --nnlm-rescore``.

``--unit-ngram`` estimates a Kneser-Ney bigram over unit ids
(``lm.unit_ngram``): BPE units with ``--bpe``, else the lexicon's phone ids,
on the transcripts but the last ``--heldout-frac``, reports the held-out
unit perplexity and writes <run-dir>/unit_lm.npz for the CTC prefix beam's
shallow fusion (``decode``/``stream --ctc --bpe --fusion-lm``). The
estimate is host work. Records go to <run-dir>/metrics.jsonl.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mogasr_torch.cli.common import add_corpus_args, add_run_args, device_of, load_corpus, make_logger
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--nnlm-arch", default="lstm", choices=["lstm", "transformer"],
                   help="neural LM architecture: LSTM (K4 on the card) or causal Transformer")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--heldout-frac", type=float, default=0.1, help="fraction of transcripts held out for perplexity")
    p.add_argument("--unit-ngram", action="store_true",
                   help="estimate a KN bigram over UNIT ids for shallow fusion (decode/stream --fusion-lm): BPE "
                        "units with --bpe, else lexicon PHONE ids")
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (with --unit-ngram)")
    p.add_argument("--kn-discount", type=float, default=0.75)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = device_of(args.device)
    corpus, lex = load_corpus(args)
    logger = make_logger(args)

    transcripts = [[w.lower() for w in words] for _, _, words in corpus]
    n_held = max(1, int(len(transcripts) * args.heldout_frac))
    train, held = transcripts[:-n_held], transcripts[-n_held:]
    if not args.unit_ngram:
        _train_nnlm(args, train, held, device, logger)
        return
    from mogasr_torch.lm.unit_ngram import estimate_unit_bigram, save_unit_lm, unit_perplexity

    if args.bpe:
        from mogasr_torch.data.bpe import load_bpe

        bpe = load_bpe(args.bpe)
        encode, n_units, kind = bpe.encode, bpe.n_units, "bpe"
    else:
        # phone expansion needs the lexicon's casing, not the lowercased word-LM view
        raw = [list(words) for _, _, words in corpus]
        train, held = raw[:-n_held], raw[-n_held:]

        def encode(s):
            return lex.words_to_phone_ids(s, oov="sil")

        n_units, kind = lex.n_phones, "phone"
    with Timer() as t:
        lm = estimate_unit_bigram([encode(s) for s in train], n_units, discount=args.kn_discount)
    ppl = unit_perplexity(lm, [encode(s) for s in held])
    out = os.path.join(os.path.abspath(args.run_dir), "unit_lm.npz")
    save_unit_lm(out, lm)
    logger.log({"stage": "train_unit_lm_done", "wall_sec": t.seconds, "heldout_unit_ppl": round(ppl, 3),
                "n_units": n_units, "units": kind, "train_sents": len(train)})
    print(f"saved {kind}-unit bigram LM to {out} (held-out unit ppl {ppl:.2f}, V={n_units})")


def _train_nnlm(args, train, held, device, logger) -> None:
    """The neural word LM: train, held-out perplexity beside the KN bigram
    baseline on the in-vocabulary held-out rows, <run-dir>/nnlm."""
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.lm import neural as NL
    from mogasr_torch.lm.ngram import estimate_bigram_kn, sequence_logp

    vocab = NL.vocab_from_transcripts(train)
    # held-out OOVs go to <unk> in the neural model but have no count in the baseline
    known = set(vocab.tokens)
    held_iv = [s for s in held if all(w in known for w in s)]
    cfg = TrainConfig(nn_hidden=args.hidden, nn_layers=args.layers, lr=args.lr, num_nn_steps=args.steps)
    with Timer() as t:
        model, _ = NL.train_nnlm(train, vocab, cfg, batch_size=args.batch_size, arch=args.nnlm_arch,
                                 logger=logger, device=device)
    ppl = NL.nnlm_perplexity(model, vocab, held)
    kn_ppl = None
    if held_iv:
        kn = estimate_bigram_kn(train, list(vocab.tokens))
        nll, n_tok = 0.0, 0
        for s in held_iv:
            nll -= sequence_logp(kn, s)
            n_tok += len(s) + 1  # eos counts, as in nnlm_perplexity
        kn_ppl = float(np.exp(nll / n_tok))
    ckpt = os.path.join(os.path.abspath(args.run_dir), "nnlm")
    NL.save_nnlm(ckpt, model, vocab)
    logger.log({"stage": "train_nnlm_done", "arch": args.nnlm_arch, "steps": args.steps, "wall_sec": t.seconds,
                "heldout_ppl": round(ppl, 3), "kn_bigram_ppl": round(kn_ppl, 3) if kn_ppl is not None else None,
                "vocab": vocab.n_tokens, "train_sents": len(train)})
    print(f"saved neural LM to {ckpt} (held-out ppl {ppl:.2f}"
          + (f", KN bigram baseline {kn_ppl:.2f})" if kn_ppl else ")"))


if __name__ == "__main__":
    main()

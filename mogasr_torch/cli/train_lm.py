"""Language-model training over corpus transcripts: the twin of the reference's
cli/train_lm.py on its ``--unit-ngram`` path.

    python -m mogasr_torch.cli.train_lm --synthetic 200 --unit-ngram [--bpe runs/ctc/bpe.json] \\
        [--kn-discount 0.75] [--heldout-frac 0.1] [--run-dir DIR]

``--unit-ngram`` estimates a Kneser-Ney bigram over unit ids
(``lm.unit_ngram``): BPE units with ``--bpe``, else the lexicon's phone ids,
on the transcripts but the last ``--heldout-frac``, reports the held-out
unit perplexity and writes <run-dir>/unit_lm.npz for the CTC prefix beam's
shallow fusion (``decode``/``stream --ctc --bpe --fusion-lm``). The
estimate is host work; ``--device`` (default cuda) is checked as every twin
checks it. Records go to <run-dir>/metrics.jsonl.

Not ported yet, and raising NotImplementedError naming ROADMAP item 13: the
neural word LM (the default path, ``lm/neural.py``). Its options are
accepted as the reference's are.
"""

from __future__ import annotations

import argparse
import os

from mogasr_torch.cli.common import add_corpus_args, add_run_args, device_of, load_corpus, make_logger
from mogasr_torch.utils.metrics import Timer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_corpus_args(p)
    add_run_args(p)
    # the neural word LM's options, accepted as the reference's are; that path raises
    p.add_argument("--nnlm-arch", default="lstm", choices=["lstm", "transformer"],
                   help="neural LM architecture (not ported yet: the neural path raises)")
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
    if not args.unit_ngram:
        raise NotImplementedError("the neural word LM is not ported to mogasr_torch yet (ROADMAP item 13: "
                                  "lm/neural.py); --unit-ngram is")
    device_of(args.device)
    corpus, lex = load_corpus(args)
    logger = make_logger(args)
    from mogasr_torch.lm.unit_ngram import estimate_unit_bigram, save_unit_lm, unit_perplexity

    transcripts = [[w.lower() for w in words] for _, _, words in corpus]
    n_held = max(1, int(len(transcripts) * args.heldout_frac))
    train, held = transcripts[:-n_held], transcripts[-n_held:]
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


if __name__ == "__main__":
    main()

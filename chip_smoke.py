#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mogasr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
takes no arguments and imports nothing of the JAX package ``mogasr`` or of
jax. Each phase prints one line, with the seconds since the script started;
any failure raises, so the exit code is nonzero and no result line is
printed. Without a CUDA device it fails at once.

0. device: the card's name and ``nvidia-smi`` name + power limit;
1. build: compile every kernel in mogasr_torch/csrc with nvcc, in parallel;
2. K1 (csrc/gmm_score.cu, the kernel of csrc/gmm_tc.cuh: bf16 on the tensor
   cores, float32 FMA on the CUDA cores) against the plain PyTorch scorer on
   the headline GMM, float32 and bfloat16, sum and max: on random features and on one batch of the decode
   path (the 600-frame bucket, 256 x 600 frames), where bf16/max and f32/sum
   are also timed against the plain version, each beside its bound counted
   by the route the arm takes (:func:`k1_bound`);
3. K2 (csrc/viterbi.cu) against the plain PyTorch Viterbi on the headline
   word-loop graph, path, entered and score bitwise equal: on the decode
   path's batch (B=256, T=600, ragged frame counts, its K1 emissions), where
   it is also timed, on random emissions at another acoustic scale, and
   there with CTC skip transitions inside every chain (K2's skip arm); K3's
   device times on the decode path's batch, reported in phase 20;
4. the front end on the card against the NumPy oracle;
5. the decode path on the headline bundle and the 768 held-out utterances of
   bench.py (front end -> K1 bf16 max -> K2 -> path_to_tokens -> WER):
   WER, utt/s, RTF, per-stage ms, launch counts of a timed pass;
6. the same corpus through the plain float32 path on the card: transcript
   agreement with the kernel path;
7. K3f/K3b (csrc/forward_backward.cu) against the plain forward-backward in
   float32 and float64, with the arm each kernel took (chain or general):
   on the widest batch of the training corpus (32 x 550 frames: its longest
   utterance fits the 550-frame bucket; its K1 float32/sum emissions, timed
   there beside the plain scorer and the bound, with the tied-triphone align
   graphs of its transcripts: the chain arm), where they are also timed (K3f,
   K3b, the combine launch, and the three together); on random emissions with
   n_frames of 0, 1 and T, also with CTC skip transitions inside every chain
   (K3f/K3b's skip arm); and on phase 3's word loop at the same shape with
   random emissions and ragged n_frames (the general arm, timed); then K2 on
   the same training batch's align graphs and K1 emissions, the traffic of
   Viterbi EM, bitwise against the plain Viterbi, with and without CTC
   skips, timed beside the plain version and the bound, with the arm each
   row took (chain: no loop arc);
8. the training path: 2 Baum-Welch EM iterations then 1 Viterbi EM iteration
   from the headline GMM over the 1600-utterance training corpus of
   benchmarks/train_headline.py (log-likelihood per frame, frames/s and
   stage ms of each iteration, the Viterbi EM iteration's "align" stage,
   launch counts of K1, K2, K3f, K3b and the combine), the
   held-out WER of the re-estimated GMM through the decode path, one
   Baum-Welch E-step's statistics against the plain path on the card, the
   E-step's fixed-order sums (mogasr_torch/utils/segment.py) on the widest
   batch timed beside the atomic scatter-adds they replaced, and
   one more Baum-Welch iteration under ``torch.profiler`` (the card's busy
   share, its top device events, and the device time of K1, K3f, K3b and the
   combine over their launches);
9. K4 (csrc/lstm_scan.cu) against the plain LSTM recurrence, float32 and
   bfloat16: on the hybrid path's widest batch (64 x 600, the real layer-0
   and layer-1 inputs of the seeded LstmAm, 512 hidden), where it is timed
   beside the plain version (and the launch's cluster size, CTAs and rows
   printed) and, for the whole layer (input GEMM + recurrence), beside
   cuDNN's ``torch.nn.LSTM`` on the packed batch (the library yardstick,
   used nowhere else), in float32 and in bfloat16; on layer 1's inputs with every row at T, the worst
   case, where no row ends early (timed); and on a random ragged batch
   (H = 200, n_frames of 0, 1 and T);
10. the hybrid NN-HMM decode path of ``benchmarks/bench_families.py``'s lstm
   row (300-word lexicon, monophone topology: 81 pdfs, the 3048-state word
   loop, acoustic scale 0.1; 256 utterances of seed 999 in batches of 64;
   uniform priors; LstmAm 81 x 512 x 2 from seed 0): a warm and a timed
   float32 pass (front end -> LstmAm with K4 -> K2 -> tokens: utt/s, RTF,
   stage ms, launch counts, WER without a limit, the weights being random),
   a profiled pass (the card's busy share), the plain float32 path on the
   card and its transcript agreement, the bfloat16 and int8 scorers (logits
   against float32, transcript agreement), and one batch each of MlpAm,
   TdnnAm, MoeAm and BlstmAm through the scorer and K2;
11. K1w (csrc/gmm_wide.cu, the wide layout) against K1, bitwise in max mode,
   and both against the plain scorer, float32 and bfloat16, sum and max: on
   the decode path's batch (256 x 600 frames, the headline GMM; bf16/max
   timed), at bench.py's kernel-sweep scale (1000 states x 256 components x
   39 dims, N = 8192, seed 7), where K1 and K1w are timed side by side, and
   on random GMMs of 300 x 8 at D = 120 and 200 (N = 2000);
12. K5 (the int8 route of csrc/gmm_tc.cuh, entry gmm_int8 in
   csrc/gmm_score.cu) against the plain int8 scorer on the same inputs, its
   quantized operands and int8 panels made on the card compared bitwise with
   the CPU's; timed on the decode path's batch beside its bound (the int8
   products, the float epilogue, the N*S*K exps at the SFU rate, the bytes);
13. K2 with a beam against the plain Viterbi, bitwise, on the decode path's
   batch, timed beside K2 without a beam and without a backtrace;
14. two decodes of the 768 held-out utterances, each with its launch counts
   set to 0 before it and read after: through K1w (bf16/max; transcripts
   identical to phase 5's K1 run) and through K5 (int8/sum; WER limit, and
   agreement with the plain float32 sum-mode path on the card);
15. the PLP front end on the card against the NumPy oracle, 4 utterances;
16. the training entry point's recipe, ``mogasr_torch.recipes.train_headline``
   at the settings the headline bundle records in its meta (3200 utterances
   of the training corpus of phase 8 in batches of 32, ``--min-occ 60``: 10
   monophone Viterbi EM iterations to 8 components with re-estimated
   transitions, tying to <= 1200 pdfs, 12 CD iterations to 16 components),
   with its launch counts set to 0 before it and read after: tied pdfs,
   both histories, held-out WER on its 120 utterances (limit), stage and
   per-iteration seconds, collect_cd_stats's seconds and launches; its
   bundle written, read back and decoding phase 5's 768 utterances (WER
   limit); then 2 CD EM iterations run twice, and stopped after the first
   and resumed from their EM checkpoint: both bitwise equal to the first run
   in history and parameters;
17. MMI and sMBR from phase 16's monophone model: on the training batch
   with the most frames each side's statistics through K1 + K3 (numerator
   on K3's chain arm, the word-loop denominator on its general arm, arms
   checked) against a float64 run, and the EBW update from both; the
   denominator's K3 timed; 2 MMI iterations over the corpus and 1 sMBR
   iteration over SMBR_BATCHES of its batches (launches, criterion, seconds
   per stage), the held-out WER of the three models;
18. ``python -m mogasr_torch.cli.train_gmm`` on a small v2 corpus with
   --triphones, --mmi, --smbr and --bundle-out, killed once its first EM
   iteration is saved and run again: it resumes from em_ckpt, and its bundle
   loads;
19. LM decoding (``decoder.lm_viterbi``, plain PyTorch ops on the card) of
   the 768 held-out utterances on K1 bf16/max emissions, batch by batch,
   with the launch counts set to 0 before and read after: a uniform bigram
   without insertion penalty decodes K2's transcripts over the same word loop
   for every utterance; an add-alpha and a Kneser-Ney bigram estimated from
   the transcripts of phase 8's training corpus, each WER held to MAX_WER
   beside the loop decode's; the card's path and entry flags equal the
   CPU's on 32 rows of the 600-frame batch; on that batch the recursion's
   ms a batch and a frame (with and without the lattice), its device events
   a frame and the card's busy share from ``torch.profiler``, beside K2;
20. ``pipeline.decode_batch_lattices`` on the 600-frame batch with a prune
   beam (host seconds of ``lattices_from_pass``), 16 of its lattices equal to
   the CPU's arc for arc, trigram rescoring, 3-best, confusion-network and
   N-best MBR decoding of them (WER of each); ``decode_batch_with_confidence``
   and ``decode_batch_nbest`` on the 768 utterances through K2 + K3's general
   arm (launch counts set to 0 before and read after) against the plain path
   on the card (the same words, confidences within CONF_ATOL, the same order
   of alternatives more than CONF_ATOL apart); K3 timed at the decode batch's
   shape, 256 x 600 x 3048, beside its bound and the plain passes (its
   kernels' device times profiled in phase 3, early in the run);
21. ``python -m mogasr_torch.cli.decode`` (the bundle's LM path on 48 v2
   utterances; the lattice flags, --trigram-rescore --nbest --consensus cn
   --lattice-out, on the small lexicon) and ``python -m
   mogasr_torch.cli.search``, run at once: each exits 0 and logs its record,
   and the lattice archive reads back;
22. the GMM CLI twins on real corpora (:func:`gmm_cli_phase`): phase 5's
   held-out utterances written as 16-bit WAV with a JSONL manifest, 32 of
   them as FLAC in LibriSpeech layout, the native FLAC decoder built and
   loaded; ``python -m mogasr_torch.cli.{features,score,align,eval}`` run at
   once: features --check-parity --write-ark on the FLAC corpus, score and
   align with phase 16's monophone model (one matrix within K1's tolerance
   of the plain scorer, one batch's pdfs bitwise the plain path's), eval
   --bundle on the WAV corpus (WER limit) and on the FLAC corpus (the same
   transcripts), eval --consensus on the small lexicon; then score, align
   and eval in this process with the launch counts set to 0 before and read
   after (K1 and K2 only);
23. the streaming front end (``pipeline.featurize_streaming``: host framing,
   deltas and CMVN, the spectral chunk on the card) on phase 5's 768
   held-out utterances in 500 ms chunks: features within STREAM_FEATS_ATOL
   of the offline front end, then K1 bf16/max + K2 (launches counted): WER
   limit, transcripts that differ from the offline features', s and RTF;
24. the online decoder (``decoder.online.OnlineDecoder``: K2's chunk arm and
   its backtrace alone) on the K1 float32/sum scores of the 768 utterances
   in 3 batches of 256 streams, 25-frame chunks with a partial after each
   (launches counted): finalize bitwise offline K2 on every utterance; on
   the widest batch K2's chunk arm against the plain chunk step for 4
   chunks, with and without a beam (delta, started, codes, exit argmax);
   ms a chunk (process, partial), the codes buffer's bytes, the arm timed
   beside its plain version and its bound;
25. K4's carry arm (initial and final carries) on B=64, T=600, H=512 with
   ragged n_frames and rows without frames against the plain recurrence,
   float32 and bfloat16, those rows' carries bitwise; LstmAm 81 x 512 x 2
   streamed in 25-frame chunks (``am.neural.LstmAmStream``) against the
   offline LstmAm on the card (launches counted); one chunk timed beside
   the plain version, the bound and cuDNN's nn.LSTM with (h0, c0);
26. ``featurize`` with add_pitch on 8 utterances on the card against the
   CPU, ``extract_pitch`` timed; ``python -m mogasr_torch.cli.stream
   --synthetic-demo`` with and without --endpoint, ``transcribe
   --synthetic-demo --nbest 2 --ctm`` and ``eval --bundle --streaming`` on
   32 utterances, run at once, each output checked; the stream twin in this
   process with its launches counted;
27. two-pass adaptation of phase 5's 768 utterances grouped by their speaker
   (20): ``pipeline.decode_with_{fmllr,mllr,vtln}`` over the bundle's CD
   loop and align graphs, each through K1/K2 (launches counted; the pass-2
   WER limit), then on the first held-out batch's utterances of
   ADAPT_PLAIN_SPEAKERS speakers again and with ``use_kernels=False`` on
   the card: transcripts agreeing, equal warps with each speaker's margin,
   transforms within ADAPT_W_ATOL where the pass-1 alignments agree; seconds of each pass and
   peak memory; then 5 speakers corrupted (A = 0.8 I, b) and decoded SI and
   with two-pass fMLLR (tests/test_fmllr.py's check);
28. on phase 8's training corpus: ``train_sat`` (2 iterations from phase 8's
   model, run twice: bitwise equal, rising history), ``estimate_stc_batches``
   (held-out WER in its space), ``train_lda_mllt`` (context 3, 40 dims, from
   phase 16's monophone model; held-out WER against the monophone's);
29. ``am.ivector.train_ivector_extractor`` at its defaults on that corpus
   without CMVN (held-out same- against different-speaker cosine),
   ``diarize_wave`` on a 2-speaker session (DER limits) and the diarize twin
   on a 3-speaker one;
30. ``python -m mogasr_torch.cli.{eval --fmllr,eval --mllr,eval --vtln}
   --bundle`` on the 768 utterances as WAV (WER limit), ``train_gmm --lda
   3``, ``transcribe --diarize`` and ``diarize --synthetic-session``, run at
   once, each output checked; ``eval --fmllr`` on 32 utterances in this
   process with its launches counted;
31. neural CE training: phase 8's training corpus aligned with the bundle
   (K1 float32/sum, K2's chain arm) as frame labels and priors; LstmAm 1168
   x 512 x 2 (the CLI's --arch lstm --hidden 512 --layers 3) trained for
   NN_STEPS steps on the card (``am.train_nn``: the plain recurrence under
   autograd), ms a step, loss and frame accuracy first and last; every
   parameter gets a nonzero gradient, K4 in a training forward raises, and
   no kernel launches in training;
32. sequence training: ``am.nn_seq.FbLoglik`` (align graphs: K3's chain
   arm; the CD word loop: its general arm) and ``SmbrAcc`` against autograd
   through the plain forward-backward on one training batch, values and
   gradients; SEQ_STEPS MMI and sMBR steps (K3's launches counted), ms a
   step and the sMBR backward's share;
33. the trained LstmAm's hybrid decode of phase 5's 768 utterances through
   K4 and K2 (launches counted): WER against the untrained model's, which it
   must beat;
34. ConformerAm at the CLI's widths: CONF_STEPS CE steps, a hybrid decode
   of the 768 utterances (K2), its logits on the card against the CPU's;
35. the neural CLI twins in this process (launches counted): ``train_nn
   --arch lstm`` with i-vectors, MMI, --save-every and --average-last, then
   ``decode --am lstm --nn-ckpt --ivector-ckpt``; ``train_nn`` without
   i-vectors, then ``eval --am lstm --nn-ckpt``;
36. the CTC loss (``am.ctc.ctc_loss``: K3's chain arm with skips over the
   label graphs, the gradient through ``am.nn_seq.FbLoglik``) against the
   plain recursion on the card, loss and gradient, on a training batch of
   the CTC LstmAm (TrainConfig's defaults: 2 x 512 over the bundle's phones
   + blank, its encoder warm-started from phase 31's CE model) and on rows
   without labels, without frames and with labels that cannot fit (K3's
   gradient there 0); K3's
   kernels timed on the label graphs beside the plain passes and the bounds;
37. CTC_STEPS CTC steps (of a CTC_SCHEDULE-step schedule) of that model on
   phase 31's batches (K3 launches counted, no K4): ms a step, loss first
   and last;
38. the 768 held-out utterances: greedy phones on K4 (PER), and the CTC
   word loop on K4 then K2's word-loop arm with skips (WER, which must be
   below half the untrained model's); on the widest batch K2 bitwise the plain Viterbi
   and timed, K4 on the encoder timed, each beside its bound;
39. stream --ctc's path on 64 held-out streams: LstmAmStream on K4's carry
   arm, the online decoder on K2's chunk arm with skips; finalize bitwise
   offline K2 on the streamed posteriors, the chunk arm bitwise the plain
   chunk step, timed;
40. BPE CTC (CTC_BPE_MERGES merges, CTC_BPE_STEPS steps on K3); the device,
   host and native prefix beams with unit-LM fusion and biasing on held-out
   posteriors and a peaked random block: the same hypotheses; the device
   beam's ms and launches a frame;
41. distillation of a smaller student from phase 37's model (the teacher
   on K4, the loss on K3) and MPC pretraining then CTC from it;
42. the CTC paths of the CLI twins in this process (launches counted):
   ``train_nn --objective ctc`` (phones; --bpe-merges), ``train_lm
   --unit-ngram``, ``decode --ctc`` (the word loop; --bpe --bias
   --fusion-lm), ``eval --ctc --bpe``, ``stream --ctc`` (the word loop;
   --bpe --bias --fusion-lm), ``transcribe --ctc``, ``search --ctc``;
43. K2's chunk arm with a frame offset per row (``viterbi_cuda.chunk_step``
   with a [B] frame0, the serving engine's launch) at the serving shape, 64
   x 24 x 3048: ragged offsets, reused rows at 0, idle rows and a row filling
   its buffer to the end, from buffers of random bits, bitwise the plain
   chunk step scattered at the offsets; timed beside it and the bound;
44. the GMM session engine (``serving.engine.BatchedSessionEngine``) at the
   serving configuration of benchmarks/bench_serve.py (capacity 64, 24-frame
   ticks, sliding CMVN over 600 frames, the bundle's word loop, K1
   float32/sum) over the 768 held-out utterances in ragged 0.24 s events with
   slot reuse, with the launch counts set to 0 before each run and read
   after: device history with host features, then with device features, and
   host history with host features; finals against the dedicated
   per-session pipeline (StreamingFrontend + K1 + OnlineDecoder) on the
   first 64 sessions, host history against device history on all; WER;
   realtime streams a card, ms a tick on the device timeline, partial
   latency, launches a tick by counter and by kernel name and the card's
   busy share (a profiled window), synchronizing calls in ticks counted with
   ``torch.cuda.set_sync_debug_mode`` (printed with their sites);
   K1 at a tick's 1536 frames timed;
45. the CTC session engine (``BatchedCtcEngine``: K4's carry arm, host
   CtcStreamDecoders) on phase 37's LstmAm: units against the dedicated
   per-session stream on 64 sessions (host features), 256 sessions on the
   device features (streams a card, ms a tick, syncs); K4's carry arm at
   64 x 24 x 512 with idle rows timed beside plain, the bound and cuDNN;
46. the serve twin in this process over one stdin event file: the GMM
   per-session mode against --engine, --ctc --bpe (phase 42's model)
   per-session against --engine, and a --tcp round trip.

Phases 47-61 are described at their functions. Phases 62-66
(``dist_phases``) run the multi-device steps of ``mogasr_torch.dist`` in
one launch of two gloo ranks that share the card, then one rank over NCCL
in this process:
the data-parallel E-step, align, decode, CE and CTC steps at the bundle's
and phases 31 and 37's widths against one process; the same steps at world
size 1 over NCCL, bitwise; the tensor-parallel GMM score; EP, SP and PP and
the dry run of ``graft_entry`` at the reference's dry-run shapes; and
``graft_entry.entry()``.

The last three lines are the ``nvidia-smi`` line, a JSON object of the
kernels (launch counts of the decode and training paths; error against the
plain version, kernel and plain milliseconds, and the least time the card
could take, on the paths' own batches), and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "benchmarks", "headline")

# Kernel vs plain scorer, float32 and bfloat16 alike: both multiply the same
# operands (bf16-rounded ones in bfloat16 mode, where every product is exact
# in float32) and accumulate in float32, so they differ only in summation
# order, and in bf16 in the tensor cores' truncating accumulation (up to
# 7.3e-4 on the decode batch). This is the reference's own golden tolerance
# (tests/test_golden.py), with a 4x margin at the smallest |loglik|.
K1_ATOL, K1_RTOL = 1e-3, 1e-4
FRONTEND_ATOL = 3e-4      # tests/test_golden.py
MAX_WER = 0.010           # the JAX system's WER on this corpus is 0.0069
BUNDLE_WER = 0.0069
MIN_AGREEMENT = 0.99      # transcripts identical to the plain float32 path
# the decode path's arm, and the training arm at the decode batch's shape
# (phase 7 times it on the training path's widest batch)
K1_TIMED = (("bfloat16", "max"), ("float32", "sum"))

# K3f/K3b vs the plain forward-backward. loglik: the lse over states sums in
# another order, far below rtol 1e-5 at |loglik| ~ 1e4. Posteriors: the
# kernels round every float op as the plain float32 version does, so their pdf
# posteriors sit within FB_POST_ATOL of it (read on the H100: 1.9e-34 on the
# training batch, 6.0e-8 on the random one). As a second guard both are held
# against a float64 run: log_gamma = alpha + beta - loglik cancels values
# ~1e4 at T = 550, so float32 alone puts the plain version's pdf posteriors
# 0.0279 (training batch) and 0.0147 (random) from float64; the kernels must
# be within FB_POST64_ATOL of float64 and no further from it than
# FB_ERR_RATIO times the plain float32 version (or FB_ERR_FLOOR, float32's own
# resolution of a posterior).
FB_LOGLIK_RTOL = 1e-5
FB_POST_ATOL = 1e-4
# The word loop's rows have loop arcs, so there K3f/K3b take the general arm,
# whose logsumexp over states sums in another order than torch.logsumexp: at
# T = 550 that alone moves float32 pdf posteriors by up to 2.5e-4 (read on the
# H100, also with the earlier one-block-per-row kernels, whose arithmetic the
# general arm keeps; the plain version on the CPU against the plain version
# on the card: up to 7.9e-5),
# so no order but torch's stays within FB_POST_ATOL of plain float32 there.
# That case is held to the float64 guards below and its distance from plain
# float32 is printed.
FB_POST64_ATOL = 0.05
FB_ERR_RATIO, FB_ERR_FLOOR = 2.0, 1e-6
# Baum-Welch statistics of one batch, kernel path (K1 + K3f/K3b) vs plain
# path (plain scorer + plain forward-backward): the scorers differ in
# summation order, which moves occ/sx/sxx by 3.8e-6, 6.5e-6 and 1.85e-5 of
# their largest entry (read on the H100).
STATS_TOL = 1e-4          # max |kernel - plain| / max |plain|, per statistic
BW_MAX_DROP = 1e-3        # Baum-Welch loglik per frame may not fall further

# The training corpus of benchmarks/train_headline.py:72-84 and its batching.
TRAIN_UTTS, TRAIN_VOCAB, TRAIN_SPEAKERS, TRAIN_SEED = 1600, 300, 20, 100
TRAIN_BUCKETS = (250, 400, 550, 700)
TRAIN_BATCH = 32

# The hybrid path of benchmarks/bench_families.py (its lstm row, at its
# defaults): 300 words, 256 utterances of seed 999 (3-9 words, 12 speakers),
# batches of 64, TrainConfig(nn_hidden=512, nn_layers=3).
HYB_VOCAB, HYB_UTTS, HYB_SPEAKERS, HYB_SEED = 300, 256, 12, 999
HYB_BATCH, HYB_BUCKETS = 64, (250, 350, 450, 600)
HYB_HIDDEN, HYB_LAYERS, HYB_ACOUSTIC_SCALE = 512, 3, 0.1
# With flax's initializers the LstmAm's logits spread ~0.1 and every
# utterance decodes to silence; its head scaled by this gain gives peaked
# posteriors, so the decodes below emit words and their agreement means
# something. Timing does not depend on the weights.
HEAD_GAIN = 100.0
# K4 vs the plain recurrence: float32 sums in another order (readings on the
# H100 below 1e-6 at 64 x 600 x 512); in bf16 mode h is rounded to bf16 every
# frame from values that differ in the last float32 bits, so an occasional
# rounding flips and the flips compound over the frames (readings up to 7e-4).
K4_ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Kernel path vs plain path, float32 logits of the whole model (BlstmAm here).
NN_ROUTE_ATOL = 1e-4
# bf16 and int8 logits vs float32 on valid frames: the reference's bf16 bound
# (tests/test_lstm_pallas.py:84), atol and rtol 0.05.
QUANT_TOL = 0.05
# Float operations of the gate math per hidden unit and valid frame: three
# sigmoids (exp, add, divide) and two tanh, the c and h updates.
K4_GATE_OPS = 15

# Published H100 SXM peaks (NVIDIA's data sheet, dense): bytes over HBM,
# operations at the rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# exps per SM and clock on the special-function units (Hopper's SFU rate)
SFU_EXPS_PER_SM_CLOCK = 16
# Float operations per graph state and frame (a transcendental counts as
# one): K2 emission scale and add, stay/advance/enter adds, three maxes, the
# exit add; K3f and K3b on a row with a loop arc the exit (enter) add and its
# share of the lse (max, sub, exp, add), stay/advance/enter adds, two
# logaddexps (max, sub, abs, neg, exp, log1p, add each), emission scale and
# add; on a row without one (the chain arm, or the block arm without the
# logsumexp) the stay/advance adds, one logaddexp, emission scale and add;
# the combine, alpha + beta - loglik.
K2_OPS, K3_LOOP_OPS, K3_CHAIN_OPS, K3_COMBINE_OPS = 9, 22, 11, 2
# K2 on a row without a loop arc (its chain arm): the emission scale and add,
# stay and advance adds, their max
K2_CHAIN_OPS = 5
# K5's float epilogue per (frame, component, state): int-to-float, two
# dequantizing products and the bias add, then the online logsumexp's
# compare, subtract, exp and add. It runs on the CUDA cores beside the int8
# products, so its time at the float32 rate, the products' time at the int8
# rate and the exps' at the SFU rate overlap: the bound takes the largest.
K5_EPILOGUE_OPS = 8
# K1's and K1w's epilogue per (frame, component, state) on the CUDA cores:
# the bias add and the max, or in sum mode K5's count
K1_EPILOGUE_OPS = {"max": 2, "sum": K5_EPILOGUE_OPS}
# bench.py's kernel sweep (its BASELINE configs[1] scoring scale), seed 7
SWEEP_S, SWEEP_K, SWEEP_N, SWEEP_SEED = 1000, 256, 8192, 7
# Feature widths past the headline's 39 that K1 and K1w must take (phase
# 11): fbank with deltas (40 x 3, two row chunks of 128) and 200 (float32
# restages its frame tile for each of four chunks)
WIDE_FEATURE_DIMS = (120, 200)
K2_BEAM = 60.0  # in acoustic-scale-multiplied log units (headline scale 1.0)

# The training entry points (phases 16-18). The statistics sum in a fixed
# order (mogasr_torch/utils/segment.py), so a stop-and-resume of CD EM on the
# card equals the uninterrupted run bit for bit, as does a second
# uninterrupted run (CD_EM_CHECK_ITERS iterations: 3 before the AED slice,
# cut for the run's time limit).
CD_EM_CHECK_ITERS = 2
# MMI at its acoustic scale on one training batch: each side's statistics
# (numerator: align graphs, K3's chain arm; denominator: the word loop, its
# general arm) through K1 + K3 against a float64 run of the plain
# forward-backward on the same K1 scores, max |kernel - f64| / max |f64| per
# statistic, and the EBW updates from them, max |kernel - f64|. Float32
# alone moves both (the plain float32 run is measured beside): the kernels
# must be within the limit and no further from float64 than FB_ERR_RATIO
# times plain float32 (or the floor). At T = 550 float32 alone puts each
# frame's posteriors ~1e-3 from summing to one (alpha + beta - loglik
# cancels values ~1e3 at this scale), so plain float32 statistics sit ~1e-3
# of their largest entry from float64 (6.6e-4 numerator, 9.2e-4 denominator
# on a CPU run of a small recipe's widest batch). EBW divides by occ_num -
# occ_den + D, so a Gaussian with little occupancy moves further than its
# statistics.
MMI_SCALE = 0.1
MMI_STATS_TOL, MMI_STATS_FLOOR = 1e-2, 1e-5
MMI_PARAM_ATOL, MMI_PARAM_FLOOR = 1e-2, 1e-4
# sMBR's iteration runs over the first SMBR_BATCHES of the recipe's 102
# training batches: its host frame loops took 86 s over all of them on a
# slower card's host, the most of any phase (cut for the run's time limit:
# 34 before the AED slice, 8 since).
SMBR_BATCHES = 8
# the CLI twin's corpus and schedule (phase 18): small, but every stage runs
CLI_ARGS = ["--synthetic-v2", "48", "--num-components", "2", "--num-iters", "6", "--triphones", "200",
            "--mmi", "1", "--smbr", "1"]
CLI_TIMEOUT_S = 300

# LM decoding, lattices and confidence (phases 19-21). The LM recursion is
# plain PyTorch ops, elementwise or exact reductions (first-index max, the
# segment max and argmin through scatter_reduce's atomic amax/amin), so the
# card's path and entry flags equal the CPU's bitwise on a slice of a decode
# batch; its score is held to LM_SCORE_RTOL.
LM_CPU_ROWS, LM_SCORE_RTOL = 32, 1e-5
# Lattices: a prune beam keeps a batch's lattices small (an unpruned one
# holds ~n_frames x 301 arcs, ~165k an utterance); LAT_CHECK_UTTS of them
# against the CPU's lattices of the same emissions, arc for arc, the scores
# within LAT_SCORE_ATOL (they are exit score minus entry base, ~1e3 each).
LAT_PRUNE_BEAM, LAT_CHECK_UTTS, LAT_SCORE_ATOL = 10.0, 16, 1e-3
# Confidence through K2 + K3's general arm against the plain path on the
# card: K3's float32 posteriors sit up to 2.5e-4 from plain float32 on the
# word loop (the logsumexp's order), and both round to 4 decimals.
CONF_ATOL = 1e-3
# The decode CLI twin (phase 21): the LM path at the bundle's width on phase
# 18's v2 corpus size; the lattice flags on the small lexicon's shortest
# two-word utterance (seed 34, 72 frames): the reference CLI has no prune
# beam, and its trigram passes over an unpruned lattice cost arcs x LM
# contexts on the host (~15 s for this one utterance on a CPU core).
CLI_DECODE_RUNS = {
    "bundle LM path": ["--synthetic-v2", "48", "--bundle", os.path.join("benchmarks", "headline"), "--bigram-lm",
                       "--lm-smoothing", "kn"],
    "lattice flags": ["--synthetic", "1", "--synthetic-seed", "34", "--bigram-lm", "--trigram-rescore", "--nbest",
                      "3", "--consensus", "cn"],
}
CLI_SEARCH_ARGS = ["--synthetic", "2", "--synthetic-seed", "34", "--terms", "thin,way,bee day", "--threshold", "0.05"]
# The GMM CLI twins on real corpora (phase 22): phase 5's held-out utterances
# written as 16-bit WAV with a JSONL manifest, CLI_FLAC_UTTS of them as FLAC
# in LibriSpeech layout (the encoder is pure Python: ~0.1 s a second of
# audio). ``eval --consensus`` runs the reference's confusion network over
# unpruned lattices on the host: on the bundle's 301-word loop an utterance's
# lattice holds ~1e5 arcs and takes minutes there, so, as phase 21's lattice
# flags, it runs on the small lexicon (random GMM, seed 34).
# CLI_COUNT_UTTS of the WAV corpus go through score, align and eval in this
# process for the launch counts.
CLI_FLAC_UTTS, CLI_COUNT_UTTS, CLI_CONSENSUS_UTTS = 32, 32, 8

# Online and streaming (phases 23-26). The streaming front end's features
# against the offline front end's: the reference's limit for
# featurize_streaming (tests/test_streaming.py), at eval --streaming's
# default chunk of 500 ms.
STREAM_CHUNK_MS, STREAM_FEATS_ATOL = 500.0, 5e-4
# The online decoder: streams of the held-out corpus in batches of 256,
# 25-frame chunks (250 ms, cli/stream.py's default), K2's chunk arm against
# the plain chunk step on the first chunks of the widest batch.
ONLINE_BATCH, ONLINE_TC, ONLINE_CHECK_CHUNKS = 256, 25, 4
# The streaming LstmAm (bench_families.py's lstm row, 81 pdfs x 512 x 2)
# against the offline LstmAm on the card: the reference's contract for any
# chunking (tests/test_nn_stream.py).
STREAM_NN_PDFS, STREAM_NN_HIDDEN, STREAM_NN_ATOL = 81, 512, 1e-5
# featurize with add_pitch on the card against the CPU: the reference's
# pitch tolerance (tests/test_pitch.py); eval --streaming's corpus size.
PITCH_UTTS, PITCH_ATOL, STREAM_CLI_EVAL_UTTS = 8, 1e-5, 32

# Speaker adaptation (phases 27-30). The two-pass decodes of the held-out
# corpus group it by each utterance's speaker (20 speakers); each runs
# through K1/K2 and again with use_kernels=False on the card: transcripts
# agree on MIN_AGREEMENT of the utterances, VTLN's warps are equal, and a
# speaker whose pass-1 alignment is the same on both paths gets a transform
# within ADAPT_W_ATOL (float32 statistics summed in another order). The
# reference's adaptation check (tests/test_fmllr.py:128-167): CORRUPT_SPEAKERS
# speakers' features through A = 0.8 I, b = CORRUPT_B N(0, 1) (seed 9, one
# draw burnt), the SI WER on them above CORRUPT_MIN_SI_WER (the test's
# precondition: the corruption must hurt) and the adapted WER below
# CORRUPT_RATIO x the SI WER. The test's own b = 0.5 N(0, 1) (TEST_B) hardly
# hurts the headline system, so its precondition fails there; the phase
# prints that SI WER beside the one at CORRUPT_B, where pass 1 is still
# partly right (b = 1.0 N(0, 1) puts the SI WER above 1).
ADAPT_W_ATOL = 1e-3
ADAPT_PLAIN_SPEAKERS = 5  # speakers of phase 27's plain-path comparison (in the first held-out batch)
CORRUPT_SPEAKERS, CORRUPT_B, TEST_B, CORRUPT_MIN_SI_WER, CORRUPT_RATIO = 5, 0.7, 0.5, 0.15, 0.6
# SAT from phase 8's model; LDA+MLLT booted from phase 16's monophone model
# at its recipe's settings (8 components, 10 EM iterations); its held-out
# WER within LDA_WER_GAP of the monophone's (tests/test_lda.py:178), STC's
# within STC_WER_GAP of its model's (tests/test_stc.py).
SAT_ITERS, LDA_CONTEXT, LDA_DIM, LDA_WER_GAP, STC_WER_GAP = 2, 3, 40, 0.02, 0.05
# i-vectors: same-speaker cosine above different-speaker by IVEC_MARGIN
# (tests/test_ivector.py:134); diarization: tests/test_diarization.py:83-87.
IVEC_MARGIN, DER_MAX, DER_ONE_SPEAKER_GAP = 0.1, 0.30, 0.05
ADAPT_CLI_TIMEOUT_S = 600
# Neural acoustic-model training (phases 31-35). Phase 31 aligns the
# training corpus of phase 8 with the headline bundle (K1 float32/sum, K2's
# chain arm) and trains the CLI's --arch lstm --hidden 512 --layers 3
# (LstmAm, 2 x 512, 1168 pdfs) on its batches of at most NN_TRAIN_T frames
# for NN_STEPS frame-CE steps at peak learning rate NN_LR: the plain
# recurrence under autograd (K4 has no backward). Phase 32 holds the
# sequence-training Functions on K3 against autograd through the plain
# forward-backward on one such batch: FbLoglik on the align graphs (K3's
# chain arm) to the reference's identity tolerance, on the CD word loop (its
# general arm) and SmbrAcc within SEQ_LOOP_ATOL (K3's word-loop posteriors
# sit up to 2.5e-4 from plain float32, phase 7, and the gradients are
# kappa times pdf sums of them); then SEQ_STEPS MMI and sMBR steps.
# The recurrence's step is paced by its launches, about as many at 128
# rows as at 32, so the steps take NN_MERGE of the corpus's batches of 32
# of one width at once.
NN_HIDDEN, NN_LAYERS, NN_STEPS, NN_LR, NN_TRAIN_T, NN_MERGE = 512, 3, 48, 3e-3, 400, 4
SEQ_SCALE, SEQ_STEPS = 0.1, 3
SEQ_CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)
SEQ_LOOP_ATOL = 1e-3
# E[acc] sums the posteriors of every frame: K3's and plain float32's differ
# by their word-loop posteriors' distance
SEQ_ACC_RTOL = 1e-3
# ConformerAm at the CLI's widths (hidden 512, 3 blocks, 4 heads, kernel 15):
# CONF_STEPS CE steps, a hybrid decode, and its forward on the card against
# the CPU on CONF_CPU_UTTS held-out utterances (float32 both: cuBLAS with
# TF32 off and the CPU's GEMMs sum in other orders).
CONF_STEPS, CONF_LR, CONF_CPU_UTTS, CONF_CPU_ATOL = 12, 1e-3, 4, 1e-3
# CTC (phases 36-42). The CTC LstmAm at TrainConfig's defaults (2 x 512)
# over the bundle lexicon's phones + blank; its encoder starts from phase
# 31's CE-trained LstmAm (``train_ctc_units``'s warm start: the cells copied,
# a fresh head) and takes CTC_STEPS steps of a CTC_SCHEDULE-step schedule at
# peak CTC_LR on phase 31's merged training batches (live rows only; the
# steps are the plain recurrence's, 0.8-1.2 s each by the machine, so the run
# stops before the schedule's tail). At 40 steps of a 40-step schedule at
# 3e-3 the model sat on CTC's blank plateau (held-out WER 0.9992 against
# the untrained model's 0.9974 on an H100, PERF.md, PR 15), and a 60-step
# schedule decays the rate before the model leaves it.
# The loss through K3 against the plain recursion on the card: the loss's
# float32 sums run in another order (CTC_LOSS_RTOL, relative); the gradient
# with respect to the logits is the posterior identity, whose alpha + beta -
# loglik cancels values ~1e3 at T = 400 in float32 (so do autograd's sums
# through the recursion: the two float32 gradients sat 1.4e-3 apart on the
# H100), so both are held to the float64 recursion's gradient as phase 7
# holds K3's posteriors: within CTC_GRAD_RATIO times plain float32's distance
# from it (the first reading: 1.70e-3 against plain's 8.96e-4, 1.9x; the
# identity sums a unit's states after the exp, autograd in the log domain),
# at most FB_POST64_ATOL; on the edge rows (T = 7) the tolerance of the CPU
# tests, CTC_GRAD_ATOL.
# The online decode of the CTC word loop streams CTC_STREAM_ROWS held-out
# rows in ONLINE_TC-frame chunks through LstmAmStream. BPE: CTC_BPE_MERGES
# merges of the training transcripts, CTC_BPE_STEPS steps; the prefix beams
# (width CTC_BEAM) on CTC_BEAM_UTTS held-out utterances and on a peaked
# random block of CTC_BEAM_FRAMES frames, scores within CTC_BEAM_RTOL (the
# device beam sums in float32, the host in float64: on long utterances
# float32 may reorder the ranked tail, so there the best hypotheses are held
# equal, as the reference's tests hold them).
# Distillation: CTC_DISTILL_STEPS steps of a 2 x CTC_DISTILL_HIDDEN student.
CTC_STEPS, CTC_SCHEDULE, CTC_LR = 60, 80, 1e-2
CTC_LOSS_RTOL, CTC_GRAD_ATOL, CTC_GRAD_RATIO = 1e-4, 1e-5, 4.0
CTC_STREAM_ROWS = 64
CTC_BPE_MERGES, CTC_BPE_STEPS, CTC_BEAM, CTC_BEAM_UTTS, CTC_BEAM_FRAMES = 200, 6, 8, 8, 60
CTC_BEAM_RTOL = 2e-4  # the reference's device-beam tolerance, tests/test_ctc_device_beam.py
CTC_DISTILL_STEPS, CTC_DISTILL_HIDDEN, CTC_INIT_STEPS = 4, 256, 2
# The serving configuration of benchmarks/bench_serve.py (:42-43, 93-111,
# 199-216): capacity 64 slots, 24-frame ticks, sliding CMVN over 600
# frames, the headline bundle's word loop (J = 3048), K1 float32/sum, the
# device history bounded at 3000 frames a session (30 s). Each live session
# sends its next 0.24 s audio event with probability SERVE_FEED_P a tick
# (ragged arrival); partials of every live session every SERVE_PARTIAL_EVERY
# ticks. The dedicated per-session pipeline decodes the first SERVE_GATE
# sessions; a profiled and a sync-counting window of SERVE_PROFILE_TICKS
# ticks each start at tick SERVE_WINDOW_AT. The CTC engine serves the first
# SERVE_CTC_UTTS held-out utterances; the serve twin SERVE_CLI_SESSIONS
# interleaved sessions.
SERVE_CAPACITY, SERVE_TICK, SERVE_CMVN_WINDOW, SERVE_MAX_FRAMES = 64, 24, 600, 3000
SERVE_FEED_P, SERVE_PARTIAL_EVERY, SERVE_GATE, SERVE_SEED = 0.75, 8, 64, 44
SERVE_PROFILE_TICKS, SERVE_WINDOW_AT, SERVE_CTC_UTTS, SERVE_CLI_SESSIONS = 24, 40, 256, 8
# queued_ms's sleep: ~50 ms at the H100's 1980 MHz, far longer than the
# host takes to queue a timed run of calls
QUEUE_SLEEP_CYCLES = 100_000_000
# RNN-T and the neural LM (phases 47-54). The model of bench_families.py's
# rnnt row (:39-40, 130-135): build_rnnt_model(n_phones, TrainConfig(
# nn_hidden=512, nn_layers=3)), an LstmAm encoder 2 x 512 (its cells
# warm-started from phase 31's CE model, as phase 37 warm-starts CTC), the
# stateless prediction net (128), the joint (256) and the auxiliary CTC
# head; RNNT_STEPS steps of an RNNT_SCHEDULE-step schedule at peak RNNT_LR on
# phase 37's merged batches (the depth is cut, not the width). Its held-out
# greedy PER must fall below half the untrained model's (whose insertions
# put it far above 1) and below RNNT_PER_MAX, under the empty hypothesis's 1
# (at this depth the model still deletes most phones; the sub/del/ins counts
# are printed). The loss on
# the card is held to the float64 NumPy DP (rnnt_loss_np) on RNNT_CHECK rows
# of the first batch (edge rows among them) to RNNT_LOSS_RTOL; its gradient
# (rnnt_loss runs in float32, as the reference's does) from the DP's in
# float64 within RNNT_GRAD_RATIO times rnnt_loss's on the CPU (float32's own
# rounding: the NLL of a 400-frame row is ~1e3, and the occupancies cancel
# it; the card's gradient sat 9.09e-5 from the CPU's float32 one), at least
# FB_ERR_FLOOR, at most FB_POST64_ATOL as phase 36's. The greedy decoders are held equal
# on RNNT_GREEDY_ROWS rows, the device beam (width RNNT_BEAM, u_cap
# RNNT_U_CAP as the bench row) to rnnt_beam_decode_batch on RNNT_BEAM_UTTS
# utterances (2 before the AED slice, 1 since, for the run's time limit:
# the device beam took 12.1 s on 2; it sums in float32, the host beam in float64:
# scores within the reference's relative RNNT_BEAM_RTOL). RNNT_PRUNED_STEPS pruned steps
# (band RNNT_BAND) and RNNT_MWER_STEPS MWER steps on RNNT_MWER_ROWS rows
# (the first steps of a schedule: step 0's learning rate is 0).
# The engine at bench_serve.py's RNN-T configuration (:331-356): capacity
# SERVE_CAPACITY, SERVE_TICK-frame ticks, V = RNNT_SERVE_UNITS (random
# prediction and joint weights on phase 48's encoder), frame-scan greedy;
# its finals against the dedicated per-session stream's on RNNT_SERVE_GATE
# sessions, with host features and with device features, exactly but for a
# session whose divergence starts at a measured near-tie: the two paths'
# input GEMMs (the spectral chunk, the LSTM's input gates) sum [B x frames]
# rows in other orders, and the random joint over 300 units has near-ties
# that an ulp flips (one session of 64 in one of three full runs; the CPU
# tests hold the engine to the reference's engine exactly). For such a
# session the dedicated path's decisions are replayed on its features, and
# the least top-2 joint logit gap between its last emission in common with
# the engine and its first differing one must be at most RNNT_TIE_GAP.
# The neural LMs at train_lm's defaults (LSTM 128 x 1, embed 64; the
# Transformer 64 wide, 2 blocks, 4 heads) for NNLM_STEPS steps.
RNNT_STEPS, RNNT_SCHEDULE, RNNT_LR, RNNT_PER_MAX = 36, 60, 3e-3, 0.9
RNNT_CHECK, RNNT_LOSS_RTOL, RNNT_GRAD_RATIO = 8, 1e-4, 4.0
RNNT_GREEDY_ROWS, RNNT_BEAM, RNNT_U_CAP, RNNT_BEAM_UTTS = 32, 4, 120, 1
RNNT_BEAM_RTOL = 2e-4  # the reference's device-beam tolerance, tests/test_rnnt_device_beam.py:58
RNNT_PRUNED_STEPS, RNNT_BAND, RNNT_MWER_STEPS, RNNT_MWER_ROWS = 3, 4, 3, 12
RNNT_SERVE_UNITS, RNNT_SERVE_GATE, RNNT_TIE_GAP, RNNT_PROFILE_TICKS = 300, 64, 1e-5, 4
NNLM_STEPS, NNLM_LR = 40, 5e-3
# The AED slice (phases 55-61) at the widths of the repo's two AED
# configurations. bench_serve.py's (:402-431): build_aed_model(n,
# TrainConfig(nn_hidden=256, nn_layers=4), chunk 8, left 1): d_model 256, 4
# encoder and 2 decoder blocks, 4 heads, kernel 15; capacity 64, beam 4, CTC
# weight 0.3, finals padded to 256 frames. bench_families.py's AED row
# (:219-228): hidden 512 and 3 layers (d_model 512, 1 decoder block) on
# phones, beam 4, 48 tokens, batches of 64 over its 256 utterances, random
# weights. Phase 55 holds aed_objective on the card (its aux CTC term on K3)
# to the same function on the CPU's plain route on AED_CHECK_ROWS rows of
# the widest merged training batch: the loss within AED_LOSS_RTOL
# (relative), the gradient of every parameter from a float64 run within
# AED_GRAD_RATIO times the CPU float32's own distance (at least
# FB_ERR_FLOOR), as phase 47 holds the RNN-T. Phase 56 trains the chunked
# bench_serve-width model from its seeded initialisation for AED_STEPS steps
# of an AED_SCHEDULE-step schedule at peak AED_LR on phase 37's merged
# batches (the depth is cut, not the width: the joint loss sits on CTC's
# blank plateau for ~600 steps, PERF.md §4), then beam-decodes the held-out
# set at decode's defaults (width AED_BEAM, CTC weight AED_CTC_WEIGHT,
# AED_MAX_TOKENS tokens): the PER must fall below half the untrained
# model's and below AED_PER_MAX. Phase 58 streams AED_STREAM_ROWS rows of
# AED_STREAM_CHUNKS chunks, held to the offline chunk-masked encoder within
# AED_STREAM_ATOL (the reference's tolerance, tests/test_aed_stream.py:49-52);
# the CTC head's logits within AED_STREAM_ATOL times their largest magnitude
# (the chunk and the whole sequence run GEMMs of other shapes: after
# training the logits sat 3.15e-5 apart, the encoder's outputs 1.24e-5).
# Phase 59: the engine over the first AED_SERVE_UTTS held-out utterances
# on device features (its finals are host-paced: the 768 took 118 s on one
# host, so they are cut, as phases 45 and 52 serve 256), its finals against
# the per-session finals on the first AED_SERVE_GATE sessions, and on
# host features on the first AED_HOST_GATE, exactly but for a session whose
# per-session beam has a top-K boundary gap or final gap of at most
# AED_TIE_GAP (batched calls sum in other orders); finalize_many against
# finalize on AED_FINALIZE_CHECK drained sessions; its busy share from a
# window of AED_PROFILE_TICKS ticks of the timed run after its sync-counting
# window (the card's activity only). Phase 60:
# AED_MWER_STEPS MWER steps on AED_MWER_ROWS rows at peak AED_MWER_LR of an
# AED_MWER_SCHEDULE-step schedule (step 0's learning rate is 0).
AED_HIDDEN, AED_LAYERS, AED_CHUNK, AED_LEFT = 256, 4, 8, 1
AED_BEAM, AED_CTC_WEIGHT, AED_MAX_TOKENS, AED_FINAL_BUCKET = 4, 0.3, 64, 256
AED_FAM_HIDDEN, AED_FAM_LAYERS, AED_FAM_TOKENS, AED_FAM_BATCH = 512, 3, 48, 64
AED_CHECK_ROWS, AED_LOSS_RTOL, AED_GRAD_RATIO = 8, 1e-5, 4.0
AED_STEPS, AED_SCHEDULE, AED_LR, AED_PER_MAX = 1100, 1200, 2e-3, 0.9
AED_STREAM_ROWS, AED_STREAM_CHUNKS, AED_STREAM_ATOL = 64, 8, 2e-5
AED_SERVE_UTTS, AED_SERVE_GATE, AED_HOST_GATE, AED_FINALIZE_CHECK = 256, 32, 16, 8
AED_TIE_GAP, AED_PROFILE_TICKS = 1e-5, 8
AED_MWER_STEPS, AED_MWER_ROWS, AED_MWER_LR, AED_MWER_SCHEDULE = 4, 32, 3e-4, 20
KERNEL_COUNTERS = ("gmm_score", "gmm_score_wide", "gmm_score_int8", "viterbi", "fb_forward", "fb_backward",
                   "fb_combine", "lstm_scan")


START = time.perf_counter()


def phase(n: int, msg: str) -> None:
    print(f"phase {n} ({time.perf_counter() - START:.0f} s): {msg}", flush=True)


def timed(fn, reps: int):
    """Median device milliseconds of ``fn()`` over ``reps`` runs after a
    warm-up, and the output of the last run."""
    out = fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def per_call_ms(fn, calls: int):
    """Device milliseconds per call of ``fn`` over ``calls`` calls issued back
    to back after a warm-up (the host's work for a call overlaps the card's
    work for the one before, as in a training loop)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def queued_ms(fn, calls: int = 20) -> float:
    """Device milliseconds per call of ``fn`` with the host's part hidden: a
    sleep kernel holds the stream while the host queues ``calls`` calls,
    which then run back to back between two CUDA events (the calls' own
    copies to the card included). No profiler: a profiling window late in
    a long run has come back without device activity."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_device_ms(fn, names, reps: int):
    """Mean device milliseconds per call of ``fn`` spent in each named
    kernel, from ``torch.profiler`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # a profiling window late in a long run has come back without the
    # kernels' device activity (phase 20, and once phase 17's second window,
    # on an H100): three more, then fail
    for _attempt in range(4):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = {name: sum(e.device_time_total for e in events if name in e.key) for name in names}
        if min(us.values()) > 0:
            return {name: t / 1e3 / reps for name, t in us.items()}
    missing = [name for name, t in us.items() if t <= 0]
    raise RuntimeError(f"the profiler recorded no device time for {missing}")


def device_profile(fn, top: int = 5, names=()):
    """Wall milliseconds of ``fn()``, the device milliseconds inside it
    (kernels, copies, memsets), the ``top`` device events by time, and for
    each of ``names`` the device milliseconds and launches of the events
    whose name contains it, from ``torch.profiler``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in on_device) / 1e3
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ranked = sorted(on_device, key=lambda e: -e.device_time_total)[:top]
    named = {n: (sum(e.device_time_total for e in on_device if n in e.key) / 1e3,
                 sum(e.count for e in on_device if n in e.key)) for n in names}
    return wall_ms, device_ms, [(e.key[:60], e.device_time_total / 1e3, e.count) for e in ranked], named


def bound(n_bytes: float, n_ops: float, dtype: str):
    """Least milliseconds for the work: the larger of bytes over the HBM rate
    and operations over the peak of their type, and which one bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n: int, s: int, k: int, d: int, dtype: str, mode: str, sfu_exps_per_s: float):
    """Least milliseconds for K1's, K1w's or K5's (dtype "int8") work on N
    frames, by the route the arm takes, and what bounds it: the largest of
    the bytes (x, or K5's quantized x2 and its row scales; the model in its
    dtype, c, K5's scales; the output) over the HBM rate; the products at the
    rate of their route (bf16 and int8 on the tensor cores, float32 FMA on
    the CUDA cores); the epilogue's float ops at the float32 rate; and in sum
    mode N*S*K exps at the SFU rate. Returns (ms, "bytes" or "operations",
    the four times)."""
    op_bytes = {"bfloat16": 2, "float32": 4, "int8": 1}[dtype]
    x_bytes = n * 2 * d + n * 4 + k * s * 4 if dtype == "int8" else n * d * 4
    n_bytes = x_bytes + k * 2 * d * s * op_bytes + k * s * 4 + n * s * 4
    products = 2 * n * s * k * 2 * d
    times = {
        "bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
        "products": products / PEAK_OPS_PER_S[dtype] * 1e3,
        "epilogue": K1_EPILOGUE_OPS[mode] * n * s * k / PEAK_OPS_PER_S["float32"] * 1e3,
        "exps": (n * s * k / sfu_exps_per_s * 1e3) if mode == "sum" else 0.0,
    }
    ms = max(times.values())
    return ms, ("bytes" if times["bytes"] == ms else "operations"), times


def emission_bytes(graphs, n_frames) -> int:
    """float32 emission bytes a pass over these graphs needs: per row, its
    frames (at least frame 0) times the distinct pdfs of its real states."""
    ids = graphs["emit_id"].cpu().numpy()
    n_states = graphs["n_states"].cpu().numpy()
    nf = n_frames.cpu().numpy()
    return 4 * sum(max(int(nf[b]), 1) * len(np.unique(ids[b, : n_states[b]])) for b in range(len(nf)))


def k2_bound(graphs, n_frames, T: int):
    """Least milliseconds (and what bounds it) of K2 with a backtrace on these
    graphs: the emissions each row's states need, the seven graph arrays (and
    skip_logp), n_frames, path and entered, the score; and the float ops of
    the arm each row takes (K2_OPS with a loop arc, K2_CHAIN_OPS without)
    on its frames."""
    B, J = graphs["emit_id"].shape
    nf = n_frames.clamp(min=0, max=T)
    loop = ((graphs["enter_logp"] > -5e29) | (graphs["exit_logp"] > -5e29)).any(dim=1)
    ops = float(((torch.where(loop, K2_OPS, K2_CHAIN_OPS) * nf.clamp(min=1)).sum() * J).item())
    n_arrays = 7 + int(graphs.get("skip_logp") is not None)
    return bound(emission_bytes(graphs, n_frames) + n_arrays * B * J * 4 + B * 4 + B * T * 5 + B * 4, ops, "float32")


def k2_chunk_bound(graphs, n_valid, started, Tc: int):
    """Least milliseconds (and what bounds it) of K2's chunk arm on one
    chunk. A row with valid frames needs the emissions of its states, the
    five graph arrays the recursion reads (emit_id and the self, advance,
    enter and exit log-probs; init_logp too where the row starts in this
    chunk, skip_logp where the graphs have it), delta in and out, and its
    frames' codes and exit argmax; every row n_valid and started in and out
    (a row without frames keeps delta in place). The float ops are k2_bound's
    on the valid frames."""
    from mogasr_torch.decoder import viterbi_cuda

    B, J = graphs["emit_id"].shape
    nv = n_valid.to(torch.int64).clamp(min=0, max=Tc)
    live = nv > 0
    n_live, n_start = int(live.sum()), int((live & ~started).sum())
    n_arrays = 5 + int(graphs.get("skip_logp") is not None)
    emissions = emission_bytes({k: graphs[k][live] for k in ("emit_id", "n_states")}, nv[live])
    n_bytes = (emissions + ((n_arrays + 2) * n_live + n_start) * J * 4
               + int(nv.sum()) * viterbi_cuda.code_frame_bytes(J) + B * (4 + 2))
    loop = ((graphs["enter_logp"] > -5e29) | (graphs["exit_logp"] > -5e29)).any(dim=1)
    ops = float(((torch.where(loop, K2_OPS, K2_CHAIN_OPS) * nv).sum() * J).item())
    return bound(n_bytes, ops, "float32")


def fb_bounds(graphs, n_frames, T: int) -> dict:
    """Least milliseconds (and what bounds them) of K3f, K3b, the combine and
    the three together on these graphs: each input byte read once (the
    emissions a row's states need, the graph arrays, n_frames), each output
    written once (alphas and betas on the frames each pass computes,
    log_gamma, loglik), and the float ops of the arm each row takes."""
    B, J = graphs["emit_id"].shape
    nf = n_frames.clamp(min=0, max=T)
    frames = int(nf.clamp(min=1).sum())  # K3f writes frame 0 of every row
    valid = int(nf.sum())
    loop = ((graphs["enter_logp"] > -5e29) | (graphs["exit_logp"] > -5e29)).any(dim=1)
    state_ops = float(((torch.where(loop, K3_LOOP_OPS, K3_CHAIN_OPS) * nf.clamp(min=1)).sum() * J).item())
    em = emission_bytes(graphs, n_frames)
    n_arrays = 7 + int(graphs.get("skip_logp") is not None)  # emit_id, the log-probs, skip_logp
    row = B * J * 4
    return {
        "fwd": bound(em + n_arrays * row + B * 4 + frames * J * 4 + B * 4, state_ops, "float32"),
        "bwd": bound(em + (n_arrays - 1) * row + B * 4 + valid * J * 4, state_ops, "float32"),
        "combine": bound(2 * valid * J * 4 + B * 8 + B * T * J * 4, K3_COMBINE_OPS * valid * J, "float32"),
        "pair": bound(em + n_arrays * row + B * 4 + B * T * J * 4 + B * 4,
                      2 * state_ops + K3_COMBINE_OPS * valid * J, "float32"),
    }


def with_chain_skips(graphs):
    """The graphs with a (j-2 -> j) skip transition of log-prob -0.1 inside
    every chain, as a CTC topology has: K2's and K3's skip arm."""
    from mogasr_torch.decoder import viterbi as vit

    chain = graphs["chain_id"]
    same = torch.zeros_like(chain, dtype=torch.bool)
    same[:, 2:] = (chain[:, 2:] == chain[:, :-2]) & (chain[:, 2:] >= 0)
    skip = torch.full(chain.shape, vit.NEG_INF, dtype=torch.float32, device=chain.device)
    skip[same] = -0.1
    return {**graphs, "skip_logp": skip}


def training_corpus(topo):
    """The training corpus of benchmarks/train_headline.py (seed 100, 3-9
    words) as data.synthetic Utterances, each with its speaker; its lexicon
    must be the bundle's."""
    from mogasr_torch.data import synthetic as syn
    from mogasr_torch.hmm.lexicon import make_lexicon

    word_lex = syn.extended_lexicon(TRAIN_VOCAB)
    lex = make_lexicon(word_lex)
    if lex.phones != topo.lexicon.phones or lex.prons != topo.lexicon.prons:
        raise RuntimeError("the training corpus's lexicon differs from the bundle's")
    utts = syn.make_corpus_v2(
        TRAIN_UTTS, lexicon=word_lex, speakers=syn.make_speakers(TRAIN_SPEAKERS),
        style=syn.CorpusStyle(), seed=TRAIN_SEED, words_per_utt=(3, 9),
    )
    return utts


def training_batches(topo, fcfg, dev):
    """The training corpus of benchmarks/train_headline.py featurized on the
    card in its batches, the widest of them (the widest bucket used, 550
    frames, the one with the most frames), the seconds its synthesis took
    and each utterance's speaker."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.config import BatchConfig
    from mogasr_torch.data.batching import make_batches

    t0 = time.perf_counter()
    utts = training_corpus(topo)
    corpus = [(u.utt_id, u.wave, u.words) for u in utts]
    synth_s = time.perf_counter() - t0
    batches = list(make_batches(corpus, BatchConfig(batch_size=TRAIN_BATCH, bucket_boundaries=TRAIN_BUCKETS), fcfg))
    frontends = pipe.frontends_for(batches, fcfg, dev)
    fbs = [pipe.featurize_batch(b, frontends[b.waves.shape[1]], dev) for b in batches]
    widest = max(fbs, key=lambda f: (f.feats.shape[1], int(f.n_frames.sum())))
    return corpus, fbs, widest, synth_s, {u.utt_id: u.speaker for u in utts}


def k2_align_times(ll, graphs, n_frames) -> dict:
    """K2 with a backtrace on align graphs, held bitwise to the plain Viterbi
    (path, entered, score) and timed: device milliseconds of its kernels (the
    profiler's events named viterbi), a call in a run of 20, one call alone,
    and the plain version. Uses only what every version of the port has, so
    it times an earlier tree's K2 the same way."""
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.decoder import viterbi_cuda

    def k2_call():
        return viterbi_cuda.viterbi(ll, graphs, n_frames)

    call_ms, got = timed(k2_call, 10)
    run_ms = per_call_ms(k2_call, 20)
    device_ms = kernel_device_ms(k2_call, ("viterbi",), 10)["viterbi"]
    plain_ms, want = timed(lambda: vit.viterbi(ll, graphs, n_frames), 2)
    torch.cuda.synchronize()
    for field in ("path", "entered", "score"):
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K2 on align graphs: {field} differs from the plain Viterbi")
    return {"ms": device_ms, "run_ms": run_ms, "call_ms": call_ms, "plain_ms": plain_ms}


def estep_sum_times(fb, gmm, topo, align_fn, graphs, n_pdfs: int) -> dict:
    """Phase 8: the E-step's fixed-order sums (mogasr_torch/utils/segment.py)
    on one training batch, device ms, each beside the atomic scatter-add it
    replaced (a yardstick, used nowhere): the hard statistics' sum over
    states on the batch's Viterbi labels (K + 2KD values a frame), and the
    collapse of its forward-backward state posteriors to pdfs."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.utils.segment import collapse_columns, index_sum

    S, K, D = gmm.means.shape
    _, labels, _ = pipe.align_batch(fb, gmm, topo.lexicon, topo, align_fn=align_fn)
    labels = labels.reshape(-1)
    safe = labels.clamp(min=0).to(torch.int64)
    per_frame = torch.rand((labels.shape[0], K * (1 + 2 * D)), device=labels.device)
    ll = pipe.score_batch(fb.feats, gmm, True, "float32", "sum")
    gamma = torch.exp(fb_cuda.forward_backward(ll, graphs, fb.n_frames).log_gamma)
    B, T, J = gamma.shape
    emit = graphs["emit_id"].to(torch.int64)
    out = {"N": labels.shape[0], "frames": int((labels >= 0).sum()), "J": J}
    out["index_sum_ms"], _ = timed(lambda: index_sum(per_frame, labels, S), 20)
    out["index_add_ms"], _ = timed(lambda: torch.zeros((S, per_frame.shape[1]), device=labels.device).index_add_(
        0, safe, per_frame), 20)
    out["collapse_ms"], _ = timed(lambda: collapse_columns(gamma, emit, n_pdfs), 20)
    out["scatter_add_ms"], _ = timed(lambda: torch.zeros((B, T, n_pdfs), device=gamma.device).scatter_add_(
        2, emit[:, None, :].expand(B, T, J), gamma), 20)
    return out


def mmi_batch_check(gmm, fb, lexicon, topo, den_graph, acoustic_scale: float = MMI_SCALE) -> dict:
    """One MMI batch, each side (numerator: the batch's align graphs;
    denominator: ``den_graph`` for every row) through K1 float32/sum and
    K3f/K3b, against a plain float64 run on the same K1 scores (the plain
    forward-backward, posteriors and statistics in float64), plain float32
    beside it; then the EBW updates from the kernel and the plain float32
    statistics against the one from the float64 statistics. Raises beyond
    the MMI_* limits. Returns each side's arms (K3f's, per row), statistic
    errors and loglik error, and the parameter errors."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import mmi
    from mogasr_torch.am.gmm import GmmSet
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder import viterbi as vit

    dev = fb.feats.device
    D = gmm.means.shape[-1]
    ll = pipe.score_batch(fb.feats, gmm)
    feats = fb.feats.reshape(-1, D)
    gmm64 = GmmSet(*(a.double() for a in gmm))
    sides = {"numerator": vit.graphs_to_torch(pipe.build_align_graphs(fb.words, lexicon, topo), dev),
             "denominator": pipe.decode_graphs(den_graph, fb.feats.shape[0], dev)[1]}
    out, stats = {}, {}
    for side, graphs in sides.items():
        sk, rk = mmi.fb_stats(gmm, feats, ll, graphs, fb.n_frames, acoustic_scale)
        arms = fb_cuda.LAST_ARMS.tolist()
        sp, _ = mmi.fb_stats(gmm, feats, ll, graphs, fb.n_frames, acoustic_scale, use_kernels=False)
        s64, r64 = mmi.fb_stats(gmm64, feats.double(), ll.double(), graphs, fb.n_frames, acoustic_scale,
                                use_kernels=False)
        torch.cuda.synchronize()
        if arms[0] != arms[1]:
            raise RuntimeError(f"MMI {side}: K3f and K3b took different arms {arms}")
        err, plain_err = {}, {}
        for field in ("occ", "sx", "sxx"):
            ref = getattr(s64, field)
            scale = float(ref.abs().max())
            err[field] = float((getattr(sk, field).double() - ref).abs().max()) / scale
            plain_err[field] = float((getattr(sp, field).double() - ref).abs().max()) / scale
            if not err[field] <= min(MMI_STATS_TOL, max(FB_ERR_RATIO * plain_err[field], MMI_STATS_FLOOR)):
                raise RuntimeError(f"MMI {side} {field}: kernels {err[field]:.3g} of max from float64 "
                                   f"(plain float32 {plain_err[field]:.3g}; limit {MMI_STATS_TOL} and "
                                   f"{FB_ERR_RATIO}x plain float32's)")
        live = fb.n_frames > 0
        ll_rel = float(((rk.loglik.double() - r64.loglik) / r64.loglik.abs())[live].abs().max())
        out[side] = {"arms": arms[0], "stats_err": err, "plain_f32_stats_err": plain_err, "loglik_rel_err": ll_rel}
        stats[side] = (sk, sp, s64)
    new_64 = mmi.ebw_update(gmm, stats["numerator"][2], stats["denominator"][2])
    for key, i in (("param_err", 0), ("plain_f32_param_err", 1)):
        new = mmi.ebw_update(gmm, stats["numerator"][i], stats["denominator"][i])
        out[key] = {f: float((getattr(new, f) - getattr(new_64, f)).abs().max()) for f in ("means", "vars")}
    for f, e in out["param_err"].items():
        if not e <= min(MMI_PARAM_ATOL, max(FB_ERR_RATIO * out["plain_f32_param_err"][f], MMI_PARAM_FLOOR)):
            raise RuntimeError(f"MMI EBW {f} from the kernel statistics {e:.3g} off the float64 update (plain "
                               f"float32 {out['plain_f32_param_err'][f]:.3g}; limit {MMI_PARAM_ATOL} and "
                               f"{FB_ERR_RATIO}x plain float32's)")
    return out


def cli_twin_phase(dev: torch.device) -> str:
    """Phase 18: ``python -m mogasr_torch.cli.train_gmm`` on a small v2
    corpus with every stage, killed once its first EM iteration is saved,
    then run again: it must resume from em_ckpt (its em_resume record) and
    write a bundle that ``load_system`` reads. Returns the phase's line."""
    import shutil
    import signal

    from mogasr_torch.utils import checkpoint as ckpt
    from mogasr_torch.utils.bundle import load_system

    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    run_dir, bundle = os.path.join(work, "run"), os.path.join(work, "bundle")
    em_ckpt = os.path.join(run_dir, "em_ckpt")
    cmd = [sys.executable, "-m", "mogasr_torch.cli.train_gmm", *CLI_ARGS, "--run-dir", run_dir, "--bundle-out", bundle,
           "--device", str(dev)]
    env = {**os.environ, "PYTHONPATH": ROOT}
    t0 = time.perf_counter()
    first = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        while ckpt.latest_step(em_ckpt) is None:
            if first.poll() is not None:
                raise RuntimeError(f"the CLI twin exited ({first.returncode}) before its first EM checkpoint: "
                                   + first.stderr.read()[-2000:])
            if time.perf_counter() - t0 > CLI_TIMEOUT_S:
                raise RuntimeError("the CLI twin wrote no EM checkpoint in time")
            time.sleep(0.05)
        first.send_signal(signal.SIGKILL)
    finally:
        if first.poll() is None:
            first.kill()
        first.wait(timeout=60)
        first.stderr.close()
    killed_s = time.perf_counter() - t0
    saved = ckpt.all_steps(em_ckpt)
    t1 = time.perf_counter()
    second = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    second_s = time.perf_counter() - t1
    if second.returncode != 0:
        raise RuntimeError(f"the CLI twin's second run failed ({second.returncode}): {second.stderr[-2000:]}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    resumed = [r for r in records if r["stage"] == "em_resume"]
    if len(resumed) != 1 or resumed[0]["step"] != saved[-1]:
        raise RuntimeError(f"the second run did not resume from the last saved step {saved}: {resumed}")
    stages = [r["stage"] for r in records]
    for want in ("train_gmm_done", "train_mmi_done", "train_smbr_done", "train_cd_done"):
        if want not in stages:
            raise RuntimeError(f"the CLI twin logged no {want!r}: {stages}")
    gmm, _topo, _fcfg, tied, meta = load_system(bundle, dev)
    if tied is None or gmm.n_states != tied.n_pdfs or not all(bool(torch.isfinite(a).all()) for a in gmm):
        raise RuntimeError("the CLI twin's bundle does not hold a finite tied-triphone GMM")
    done = {r["stage"]: r for r in records}
    return (f"CLI twin ({' '.join(CLI_ARGS)}): killed after {killed_s:.1f} s with EM steps {saved} saved; "
            f"run again ({second_s:.1f} s): resumed from step {resumed[0]['step']} of {done['train_gmm_done']['iters']}"
            f", MMI criterion {done['train_mmi_done']['criterion_last']:.4f}, sMBR expected frame accuracy "
            f"{done['train_smbr_done']['expected_acc_last']:.4f}, {tied.n_pdfs} tied pdfs (CD log-likelihood "
            f"{done['train_cd_done']['final_avg_loglik']:.4f} per frame); bundle {gmm.n_states} x {gmm.n_components}"
            f" x {gmm.feat_dim} loads (meta source {meta.get('source')})")


def training_entry_phases(dev: torch.device, corpus, bcfg, bundle_meta: dict) -> dict:
    """Phases 16 (the headline recipe at the headline bundle's own settings,
    its held-out decodes, a CD stop-and-resume), 17 (MMI and sMBR from its
    monophone model) and 18 (the CLI twin). Returns the launches per path,
    the numbers the kernels line takes from them, and the checkpoint of the
    recipe's monophone model (``mono_ckpt``, for phase 22)."""
    import shutil

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda, mmi, smbr
    from mogasr_torch.config import GmmConfig, TrainConfig
    from mogasr_torch.decoder import fb_cuda, viterbi_cuda
    from mogasr_torch.hmm import triphone as tri
    from mogasr_torch.recipes import train_headline
    from mogasr_torch.utils import checkpoint as ckpt
    from mogasr_torch.utils.bundle import load_system, save_system

    def zero_counts():
        gmm_cuda.LAUNCHES = viterbi_cuda.LAUNCHES = 0
        fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = 0
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES, "fb_forward": fb_cuda.FWD_LAUNCHES,
                "fb_backward": fb_cuda.BWD_LAUNCHES, "fb_combine": fb_cuda.COMBINE_LAUNCHES}

    # ---- phase 16: the headline recipe on the card, at the settings the
    # headline bundle was trained with (its meta: 3200 utterances, min_occ
    # 60; the script's defaults, 1600 and 100, give a system that decodes
    # phase 5's utterances above MAX_WER, PERF.md)
    work = os.path.join(ROOT, "build", "chip_smoke_recipe")
    shutil.rmtree(work, ignore_errors=True)
    args = train_headline.parse_args(["--train-utts", str(bundle_meta["train_utts"]), "--min-occ",
                                      str(bundle_meta["min_occ"]), "--out", os.path.join(work, "bundle")])
    log_lines = []
    zero_counts()
    out = train_headline.run(args, dev, log=log_lines.append)
    recipe_launches = counts()
    meta = out["meta"]
    mono, cd, tied, gmm_cd = out["mono"], out["cd"], out["tied"], out["gmm_cd"]
    if min(recipe_launches["gmm_score"], recipe_launches["viterbi"]) == 0:
        raise RuntimeError(f"the recipe did not go through K1 and K2: {recipe_launches}")
    if not (np.isfinite(mono.history).all() and np.isfinite(cd.history).all()):
        raise RuntimeError(f"recipe histories not finite: {mono.history} {cd.history}")
    if out["heldout_wer"] > MAX_WER:
        raise RuntimeError(f"the recipe's CD system: held-out WER {out['heldout_wer']:.4f} > {MAX_WER}")
    if tied.n_pdfs > args.target_pdfs or gmm_cd.means.shape != (tied.n_pdfs, args.components, out["fcfg"].feat_dim):
        raise RuntimeError(f"the recipe's CD GMM is {tuple(gmm_cd.means.shape)} for {tied.n_pdfs} tied pdfs")
    save_system(args.out, gmm_cd, out["topo"], out["fcfg"], tied=tied, meta=meta)
    b_gmm, b_topo, b_fcfg, b_tied, _ = load_system(args.out, dev)
    dcfg = out["dcfg"]
    graph_cd = tri.word_loop_graph_cd(b_tied, insertion_penalty=dcfg.word_insertion_penalty)
    zero_counts()
    t0 = time.perf_counter()
    cd_stats = pipe.collect_cd_stats(out["train"], out["gmm_mono"], b_topo.lexicon, out["topo"])
    cd_stats_s = time.perf_counter() - t0
    cd_stats_launches = counts()
    zero_counts()
    dec = pipe.decode_corpus(corpus, b_gmm, graph_cd, b_fcfg, dcfg, bcfg, dev, compute_dtype="bfloat16")
    dec_launches = counts()
    if dec.wer > MAX_WER or dec_launches["gmm_score"] == 0 or dec_launches["viterbi"] == 0:
        raise RuntimeError(f"decode with the recipe's bundle: WER {dec.wer:.4f} (limit {MAX_WER}), {dec_launches}")
    # stop-and-resume of CD_EM_CHECK_ITERS CD EM iterations from the recipe's CD model
    gcfg_cd = GmmConfig(n_states=tied.n_pdfs, n_components=args.components, feat_dim=out["fcfg"].feat_dim,
                        var_floor=args.var_floor, min_split_occ=args.min_split_occ)

    def cd_em(iters, ckpt_dir=None):
        return pipe.train_gmm(out["train"], b_topo.lexicon, out["topo"], gcfg_cd, TrainConfig(num_em_iters=iters),
                              gmm=gmm_cd, align_fn=lambda p: tri.align_graph_cd(tied, p), n_pdfs=tied.n_pdfs,
                              ckpt_dir=ckpt_dir)

    whole = cd_em(CD_EM_CHECK_ITERS)
    again = cd_em(CD_EM_CHECK_ITERS)
    cd_em(1, os.path.join(work, "em_ckpt"))
    resumed = cd_em(CD_EM_CHECK_ITERS, os.path.join(work, "em_ckpt"))
    if len(resumed.seconds) != CD_EM_CHECK_ITERS - 1 or "restore" not in resumed.setup_seconds:
        raise RuntimeError("the CD EM run did not resume from its checkpoint")
    for name, run in (("a second uninterrupted run", again),
                      (f"the run resumed after 1 of {CD_EM_CHECK_ITERS} iterations", resumed)):
        if run.history != whole.history or not all(torch.equal(a, b) for a, b in zip(run.gmm, whole.gmm)):
            param_err = max(float((a - b).abs().max()) for a, b in zip(run.gmm, whole.gmm))
            raise RuntimeError(f"CD EM: {name} is not bitwise the uninterrupted run: history {run.history} vs "
                               f"{whole.history}, parameters max |diff| {param_err:.3g}")

    def iter_text(r):
        return "; ".join(f"{s:.3f} s (" + ", ".join(f"{k} {1e3 * v:.0f}" for k, v in st.items()) + ")"
                         for s, st in zip(r.seconds, r.stage_seconds))

    n_frames = meta["train_frames"]
    phase(16, f"headline recipe at the bundle's settings (--train-utts {args.train_utts} --min-occ {args.min_occ:g}; "
          f"{args.train_utts} + {args.test_utts} utterances, {n_frames} training frames (bundle "
          f"{bundle_meta['train_frames']}), {len(out['train'])} batches of {train_headline.BATCH}; corpus not cut): "
          f"{tied.n_pdfs} tied pdfs x {gmm_cd.n_components} x {gmm_cd.feat_dim} (bundle {bundle_meta['tied_pdfs']}); "
          f"monophone history {meta['em_loglik_mono']}, CD history {meta['em_loglik_cd']} (bundle's last "
          f"{bundle_meta['em_loglik_mono'][-1]}, {bundle_meta['em_loglik_cd'][-1]}); held-out WER ({args.test_utts} "
          f"utterances) monophone {out['heldout_wer_mono']:.4f}, CD {out['heldout_wer']:.4f} (bundle "
          f"{bundle_meta['heldout_wer_mono']}, {bundle_meta['heldout_wer']}; limit {MAX_WER}); "
          f"wall {meta['wall_s']} s, "
          "stage s " + ", ".join(f"{k} {v:.2f}" for k, v in out["seconds"].items())
          + f"; monophone setup s {mono.setup_seconds}, iterations (ms): {iter_text(mono)}; CD setup s (collect_cd_"
          f"stats = cd_stats) {cd.setup_seconds}, iterations (ms): {iter_text(cd)}; launches {recipe_launches}; "
          f"collect_cd_stats again: {len(cd_stats)} triphone states in {cd_stats_s:.3f} s, launches "
          f"{cd_stats_launches}; the "
          f"bundle written and read back decodes the {dec.n_utts} held-out utterances of phase 5 at WER "
          f"{dec.wer:.4f} ({dec.n_utts / dec.seconds:.1f} utt/s; bundle {BUNDLE_WER}); {CD_EM_CHECK_ITERS} CD EM "
          f"iterations (history "
          f"{whole.history}): run again, and stopped after 1 and resumed, both bitwise equal to the first run in "
          f"history and parameters")

    # ---- phase 17: MMI and sMBR from the recipe's monophone model
    lex, topo_t, gmm_mono, tb = b_topo.lexicon, out["topo"], out["gmm_mono"], out["train"]
    den_graph = pipe.word_decode_graph(lex, topo_t, type(dcfg)(acoustic_scale=MMI_SCALE))
    # the batch with the most frames (the 700-frame bucket holds few utterances)
    widest = max(tb, key=lambda f: (int(f.n_frames.sum()), f.feats.shape[1]))
    check = mmi_batch_check(gmm_mono, widest, lex, topo_t, den_graph)
    arms = {side: sorted(set(check[side]["arms"])) for side in ("numerator", "denominator")}
    if arms["numerator"] != [fb_cuda.ARM_CHAIN] or arms["denominator"] != [fb_cuda.ARM_GENERAL]:
        raise RuntimeError(f"MMI arms: numerator {arms['numerator']}, denominator {arms['denominator']}")
    den_graphs = pipe.decode_graphs(den_graph, widest.feats.shape[0], dev)[1]
    ll_w = pipe.score_batch(widest.feats, gmm_mono)

    def den_fb():
        return fb_cuda.forward_backward(ll_w, den_graphs, widest.n_frames, acoustic_scale=MMI_SCALE)

    den_pair_ms = per_call_ms(den_fb, 20)
    den_kernel_ms = kernel_device_ms(den_fb, ("fb_forward_kernel", "fb_backward_kernel", "fb_combine_kernel"), 5)
    del ll_w, den_graphs
    zero_counts()
    mmi_res = mmi.train_mmi(tb, lex, topo_t, gmm_mono, n_iters=2, acoustic_scale=MMI_SCALE)
    mmi_launches = counts()
    last_arms = sorted(set(fb_cuda.LAST_ARMS.tolist()[0]))  # the last denominator call
    if min(mmi_launches["gmm_score"], mmi_launches["fb_forward"]) == 0 or last_arms != [fb_cuda.ARM_GENERAL]:
        raise RuntimeError(f"MMI launches {mmi_launches}, last denominator arms {last_arms}")
    zero_counts()
    smbr_res = smbr.train_smbr(tb[:SMBR_BATCHES], lex, topo_t, gmm_mono, n_iters=1, acoustic_scale=MMI_SCALE)
    smbr_launches = counts()
    evals = {name: pipe.evaluate(out["test"], g, lex, topo_t, dcfg)["wer"]
             for name, g in (("ML", gmm_mono), ("MMI", mmi_res.gmm), ("sMBR", smbr_res.gmm))}
    values = list(mmi_res.history) + list(smbr_res.history) + list(evals.values())
    if not np.isfinite(values).all() or not all(bool(torch.isfinite(a).all()) for r in (mmi_res, smbr_res)
                                                 for a in r.gmm):
        raise RuntimeError(f"MMI/sMBR: a value is not finite: {values}")
    arm_names = {fb_cuda.ARM_CHAIN: "chain", fb_cuda.ARM_BLOCK: "block", fb_cuda.ARM_GENERAL: "general"}
    phase(17, f"MMI (acoustic scale {MMI_SCALE}) from the recipe's monophone model ({gmm_mono.n_states} x "
          f"{gmm_mono.n_components}), word loop J={den_graph.n_states}: on the batch with the most frames "
          f"B={widest.feats.shape[0]} T={widest.feats.shape[1]} ({int(widest.n_frames.sum())} frames in "
          f"{int((widest.n_frames > 0).sum())} rows) K3 arms numerator {[arm_names[a] for a in arms['numerator']]}, "
          f"denominator "
          f"{[arm_names[a] for a in arms['denominator']]}; statistics vs float64, max |err| / max (limit "
          f"{MMI_STATS_TOL}): " + "; ".join(
              f"{side} " + ", ".join(f"{k} {v:.3g} (plain f32 {check[side]['plain_f32_stats_err'][k]:.3g})"
                                     for k, v in check[side]["stats_err"].items())
              + f", loglik rel {check[side]['loglik_rel_err']:.3g}" for side in ("numerator", "denominator"))
          + f"; EBW update from them vs from float64: means {check['param_err']['means']:.3g}, vars "
          f"{check['param_err']['vars']:.3g} (plain f32 {check['plain_f32_param_err']['means']:.3g}, "
          f"{check['plain_f32_param_err']['vars']:.3g}; limit {MMI_PARAM_ATOL} and {FB_ERR_RATIO}x plain f32's); "
          f"the denominator's K3f + K3b + combine "
          f"{den_pair_ms:.3f} ms a call in a run of 20 (K3f {den_kernel_ms['fb_forward_kernel']:.3f}, K3b "
          f"{den_kernel_ms['fb_backward_kernel']:.3f}, combine {den_kernel_ms['fb_combine_kernel']:.3f} ms on the "
          f"device); 2 MMI iterations over {len(tb)} batches: criterion per frame {mmi_res.history}, "
          f"{iter_text(mmi_res)}, launches {mmi_launches} (last denominator call's arm "
          f"{[arm_names[a] for a in last_arms]}); 1 sMBR iteration over {min(SMBR_BATCHES, len(tb))} of the "
          f"{len(tb)} batches: expected frame accuracy {smbr_res.history}, {iter_text(smbr_res)}, launches "
          f"{smbr_launches}; held-out WER "
          + ", ".join(f"{k} {v:.4f}" for k, v in evals.items()))

    # ---- phase 18: the CLI twin, killed and resumed
    phase(18, cli_twin_phase(dev))
    shutil.rmtree(work, ignore_errors=True)
    # the monophone model in the port's checkpoint format, for phase 22
    mono_ckpt = os.path.join(ROOT, "build", "chip_smoke_mono_ckpt")
    shutil.rmtree(mono_ckpt, ignore_errors=True)
    ckpt.save_checkpoint(mono_ckpt, gmm_mono._asdict())
    return {"mono_ckpt": mono_ckpt, "mono_gmm": gmm_mono, "mono_topo": topo_t, "recipe": recipe_launches, "recipe_decode": dec_launches, "mmi": mmi_launches,
            "smbr": smbr_launches,
            "mmi_denominator": {"pair_ms": den_pair_ms, **den_kernel_ms,
                                "launches_per_iteration": mmi_launches["fb_forward"] // 2 // 2},
            "collect_cd_stats": {"seconds": cd_stats_s, "launches": cd_stats_launches}}


def hybrid_phases(dev: torch.device) -> dict:
    """Phases 9 (K4 against its plain version) and 10 (the hybrid decode
    path); returns K4's entry of the kernels line."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import fast_lstm, lstm_cuda
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.quantize import make_quantized_logits
    from mogasr_torch.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig, TrainConfig
    from mogasr_torch.data import synthetic as syn
    from mogasr_torch.data.batching import make_batches
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.frontend.torch_frontend import make_frontend
    from mogasr_torch.hmm.lexicon import make_lexicon
    from mogasr_torch.hmm.topology import build_topology

    torch.set_grad_enabled(False)  # inference only
    # ---- phase 9: K4 against its plain version

    t0 = time.perf_counter()
    hyb_lex_words = syn.extended_lexicon(HYB_VOCAB)
    hyb_lex = make_lexicon(hyb_lex_words)
    hyb_topo = build_topology(hyb_lex, TopologyConfig())
    P = hyb_topo.n_pdfs
    hyb_dcfg = DecodeConfig(acoustic_scale=HYB_ACOUSTIC_SCALE)
    hyb_fcfg = FrontendConfig()
    hyb_graph = pipe.word_decode_graph(hyb_lex, hyb_topo, hyb_dcfg)
    hyb_corpus = [(u.utt_id, u.wave, u.words) for u in syn.make_corpus_v2(
        HYB_UTTS, lexicon=hyb_lex_words, n_speakers=HYB_SPEAKERS, seed=HYB_SEED, words_per_utt=(3, 9))]
    hyb_synth_s = time.perf_counter() - t0
    hyb_bcfg = BatchConfig(batch_size=HYB_BATCH, bucket_boundaries=HYB_BUCKETS)
    log_priors = np.log(np.full(P, 1.0 / P, np.float32))
    hyb_cfg = TrainConfig(nn_hidden=HYB_HIDDEN, nn_layers=HYB_LAYERS)

    def seeded(arch, seed=0):
        return init_(tn.build_model(arch, P, hyb_cfg, hyb_fcfg.feat_dim), torch.Generator().manual_seed(seed)).to(dev)

    lstm_am = seeded("lstm")
    hyb_batches = list(make_batches(hyb_corpus, hyb_bcfg, hyb_fcfg))
    hb = max(hyb_batches, key=lambda b: (b.waves.shape[1], int(b.num_samples.astype(np.int64).sum())))
    fbh = pipe.featurize_batch(hb, make_frontend(hyb_fcfg, hb.waves.shape[1], dev), dev)
    Bh, Th, _ = fbh.feats.shape
    H = HYB_HIDDEN
    nfh = fbh.n_frames
    valid_frames = int(nfh.clamp(min=0).sum())
    with torch.no_grad():
        xg0 = {dt: lstm_am.cells[0].input_gates(fbh.feats, dt) for dt in ("float32", "bfloat16")}
        h0 = {dt: lstm_cuda.lstm_layer(xg0[dt], lstm_am.cells[0].w_rec, nfh, dt) for dt in xg0}
        xg1 = {dt: lstm_am.cells[1].input_gates(h0[dt], dt) for dt in xg0}
    rng9 = np.random.default_rng(9)
    Hr, Br = 200, 16
    nf_r = torch.as_tensor(np.r_[Th, 1, 0, rng9.integers(2, Th, Br - 3)].astype(np.int32), device=dev)
    nf_all = torch.full_like(nfh, Th)
    layer1 = f"layer 1 of the widest batch B={Bh} T={Th} H={H}"
    all_at_t = f"layer 1's inputs with every row at T={Th}"
    k4_cases = {
        f"layer 0 of the widest batch B={Bh} T={Th} H={H}": (xg0, lstm_am.cells[0].w_rec, nfh),
        layer1: (xg1, lstm_am.cells[1].w_rec, nfh),
        all_at_t: (xg1, lstm_am.cells[1].w_rec, nf_all),
        f"random B={Br} T={Th} H={Hr} n_frames {nf_r.tolist()[:4]}...": (
            dict.fromkeys(("float32", "bfloat16"), torch.as_tensor(
                rng9.standard_normal((Br, Th, 4 * Hr)).astype(np.float32), device=dev)),
            torch.as_tensor((rng9.standard_normal((Hr, 4 * Hr)) / np.sqrt(Hr)).astype(np.float32), device=dev),
            nf_r),
    }
    k4_err, k4_ms, k4_plain_ms, k4_all_ms, k4_launch = {}, {}, {}, {}, {}
    for name, (xgs, w_rec, nf) in k4_cases.items():
        for dt in ("float32", "bfloat16"):
            xg = xgs[dt]
            if name == layer1:
                k4_ms[dt], got = timed(lambda: lstm_cuda.lstm_layer(xg, w_rec, nf, dt), 5)
                k4_launch[dt] = dict(lstm_cuda.LAST_LAUNCH)
                k4_plain_ms[dt], want = timed(lambda: fast_lstm.lstm_layer(xg, w_rec, nf, dt), 1)
            elif name == all_at_t:  # the worst case: no row ends early
                k4_all_ms[dt], got = timed(lambda: lstm_cuda.lstm_layer(xg, w_rec, nf, dt), 5)
                want = fast_lstm.lstm_layer(xg, w_rec, nf, dt)
            else:
                got, want = lstm_cuda.lstm_layer(xg, w_rec, nf, dt), fast_lstm.lstm_layer(xg, w_rec, nf, dt)
            torch.cuda.synchronize()
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"K4 {dt} ({name}): bad output {tuple(got.shape)}")
            if bool((nf == 0).any()) and float(got[nf == 0].abs().max()) != 0.0:
                raise RuntimeError(f"K4 {dt} ({name}): a row with n_frames = 0 is not zero")
            err = float((got - want).abs().max())
            if err > K4_ATOL[dt]:
                raise RuntimeError(f"K4 {dt} ({name}) disagrees with the plain recurrence: max |err| {err}")
            k4_err[(name, dt)] = err
    # the library yardstick: cuDNN's LSTM for the whole layer 1 on the packed
    # batch (rows with frames), beside the prefused input GEMM + K4
    cell1 = lstm_am.cells[1]
    cudnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(cell1.w_in.T)   # torch's gate order i, f, g, o is flax's
        cudnn.weight_hh_l0.copy_(cell1.w_rec.T)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.copy_(cell1.bias)
    live = (nfh > 0).nonzero()[:, 0]
    x1, lens = h0["float32"][live], nfh[live].to(device="cpu", dtype=torch.int64)

    def cudnn_layer():
        with torch.no_grad():
            packed = torch.nn.utils.rnn.pack_padded_sequence(x1, lens, batch_first=True, enforce_sorted=False)
            return torch.nn.utils.rnn.pad_packed_sequence(cudnn(packed)[0], batch_first=True, total_length=Th)[0]

    def gemm_k4_layer():
        with torch.no_grad():
            return cell1(h0["float32"], nfh)

    lib_ms, lib_out = timed(cudnn_layer, 5)
    layer_ms, layer_out = timed(gemm_k4_layer, 5)
    vmask = tn.valid_mask(nfh[live], Th, dev)
    lib_err = float((lib_out - layer_out[live])[vmask].abs().max())
    # the same in bfloat16: cuDNN's LSTM with bf16 weights and inputs beside
    # the bf16 input GEMM + K4's bf16 arm
    cudnn_bf16 = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    cudnn_bf16.load_state_dict(cudnn.state_dict())
    cudnn_bf16 = cudnn_bf16.to(torch.bfloat16)
    x1_bf16 = h0["bfloat16"][live].to(torch.bfloat16)

    def cudnn_layer_bf16():
        with torch.no_grad():
            packed = torch.nn.utils.rnn.pack_padded_sequence(x1_bf16, lens, batch_first=True, enforce_sorted=False)
            return torch.nn.utils.rnn.pad_packed_sequence(cudnn_bf16(packed)[0], batch_first=True,
                                                          total_length=Th)[0]

    def gemm_k4_layer_bf16():
        with torch.no_grad():
            return cell1(h0["bfloat16"], nfh, "bfloat16")

    lib_bf16_ms, lib_bf16_out = timed(cudnn_layer_bf16, 5)
    layer_bf16_ms, layer_bf16_out = timed(gemm_k4_layer_bf16, 5)
    lib_bf16_err = float((lib_bf16_out.float() - layer_bf16_out[live])[vmask].abs().max())
    k4_bytes = {dt: valid_frames * 4 * H * 4 + H * 4 * H * (4 if dt == "float32" else 2) + Bh * 4 + Bh * Th * H * 4
                for dt in ("float32", "bfloat16")}
    k4_ops = valid_frames * H * (2 * 4 * H + K4_GATE_OPS)
    k4_bound = {dt: bound(k4_bytes[dt], k4_ops, dt) for dt in k4_bytes}
    all_frames = Bh * Th
    k4_all_bound = {dt: bound(k4_bytes[dt] + (all_frames - valid_frames) * 4 * H * 4,
                              all_frames * H * (2 * 4 * H + K4_GATE_OPS), dt) for dt in k4_bytes}
    phase(9, "K4 matches the plain recurrence (atol float32 %g, bfloat16 %g), max |err|: %s; layer 1 of the "
          "widest batch (%d valid frames; a launch of %d CTAs in clusters of %d takes %d rows, bfloat16 %d CTAs "
          "in clusters of %d): K4 float32 %.3f ms (plain %.3f ms, bound %.4f ms by %s), bfloat16 %.3f ms (plain "
          "%.3f ms, bound %.4f ms by %s); "
          "every row at T (%d frames): float32 %.3f ms (bound %.4f ms), bfloat16 %.3f ms (bound %.4f ms); "
          "whole layer, input GEMM + K4 %.3f ms vs cuDNN nn.LSTM %.3f ms (valid frames max |diff| %.3g); in "
          "bfloat16 %.3f ms vs cuDNN nn.LSTM in bfloat16 %.3f ms (max |diff| %.3g)" % (
              K4_ATOL["float32"], K4_ATOL["bfloat16"],
              "; ".join(f"{n} {d} {e:.3g}" for (n, d), e in k4_err.items()), valid_frames,
              k4_launch["float32"]["ctas"], k4_launch["float32"]["cluster"], k4_launch["float32"]["rows"],
              k4_launch["bfloat16"]["ctas"], k4_launch["bfloat16"]["cluster"],
              k4_ms["float32"], k4_plain_ms["float32"], *k4_bound["float32"],
              k4_ms["bfloat16"], k4_plain_ms["bfloat16"], *k4_bound["bfloat16"], all_frames,
              k4_all_ms["float32"], k4_all_bound["float32"][0], k4_all_ms["bfloat16"], k4_all_bound["bfloat16"][0],
              layer_ms, lib_ms, lib_err, layer_bf16_ms, lib_bf16_ms, lib_bf16_err))
    del xg0, xg1, h0, k4_cases, got, want, lib_out, layer_out, x1, x1_bf16, lib_bf16_out, layer_bf16_out

    # ---- phase 10: the hybrid decode path
    peaked = seeded("lstm")
    with torch.no_grad():
        peaked.head.weight.mul_(HEAD_GAIN)

    def hybrid(model, precision="float32", use_kernels=True):
        return pipe.decode_corpus(hyb_corpus, pipe.make_nn_scorer(model, log_priors, precision, use_kernels),
                                  hyb_graph, hyb_fcfg, hyb_dcfg, hyb_bcfg, dev, use_kernels=use_kernels)

    hybrid(peaked)
    lstm_cuda.LAUNCHES = viterbi_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    hyb = hybrid(peaked)
    hyb_launches = {"lstm_scan": lstm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES}
    if min(hyb_launches.values()) == 0:
        raise RuntimeError(f"the hybrid path did not go through every kernel: {hyb_launches}")
    if hyb.n_utts != len(hyb_corpus) or not np.isfinite(hyb.scores).all():
        raise RuntimeError(f"hybrid path decoded {hyb.n_utts} of {len(hyb_corpus)} utterances, "
                           f"finite scores: {bool(np.isfinite(hyb.scores).all())}")
    hyb_words = sum(len(h) for h in hyb.hyps)
    hyb_prof_wall, hyb_prof_dev, hyb_prof_top, _ = device_profile(lambda: hybrid(peaked))
    hyb_plain = hybrid(peaked, use_kernels=False)
    same = sum(a == b for a, b in zip(hyb.hyps, hyb_plain.hyps)) / len(hyb.hyps)
    if same < MIN_AGREEMENT:
        raise RuntimeError(f"hybrid kernel path agrees with the plain f32 path on {same:.4f} of utterances")
    agree = {}
    for prec in ("bfloat16", "int8"):
        lstm_cuda.LAUNCHES = 0
        q = hybrid(peaked, prec)
        if prec == "bfloat16":
            bf16_launches = lstm_cuda.LAUNCHES  # K4's bf16 arm over a bf16 hybrid pass
        agree[prec] = sum(a == b for a, b in zip(hyb.hyps, q.hyps)) / len(hyb.hyps)
    # bf16 and int8 logits of the seeded LstmAm (flax's init scale) on the widest batch
    quant_err = {}
    vh = tn.valid_mask(nfh, Th, dev)
    with torch.no_grad():
        f32_logits = make_quantized_logits(lstm_am, "float32")(fbh.feats, nfh)[vh]
        for prec in ("bfloat16", "int8"):
            lg = make_quantized_logits(lstm_am, prec)(fbh.feats, nfh)[vh]
            quant_err[prec] = float((lg - f32_logits).abs().max())
            if not torch.allclose(lg, f32_logits, atol=QUANT_TOL, rtol=QUANT_TOL):
                raise RuntimeError(f"LstmAm {prec} logits off float32 by {quant_err[prec]} (limit {QUANT_TOL})")
    # one batch of each other family through the scorer and K2
    graphs_h = pipe.decode_graphs(hyb_graph, HYB_BATCH, dev)
    fam_line = []
    for arch in ("mlp", "tdnn", "moe", "blstm"):
        model = seeded(arch)
        before = (lstm_cuda.LAUNCHES, viterbi_cuda.LAUNCHES)
        ll = pipe.make_nn_scorer(model, log_priors)(fbh)
        toks, scores = pipe.decode_batch_scored(fbh, ll, hyb_graph, hyb_dcfg, graphs=graphs_h)
        torch.cuda.synchronize()
        launched = (lstm_cuda.LAUNCHES - before[0], viterbi_cuda.LAUNCHES - before[1])
        if ll.shape != (Bh, Th, P) or not bool(torch.isfinite(ll).all()) or not np.isfinite(scores).all():
            raise RuntimeError(f"{arch}: scores {tuple(ll.shape)} not finite or of the wrong shape")
        if launched[1] != 1 or launched[0] != (2 * model.layers if arch == "blstm" else 0):
            raise RuntimeError(f"{arch}: launched K4 {launched[0]} and K2 {launched[1]} times")
        text = f"{arch} K4 x{launched[0]}, K2 x{launched[1]}"
        if arch == "blstm":
            with torch.no_grad():
                route_err = float((model(fbh.feats, nfh)[vh] - model(fbh.feats, nfh, use_kernels=False)[vh])
                                  .abs().max())
            if route_err > NN_ROUTE_ATOL:
                raise RuntimeError(f"BlstmAm kernel route off the plain route by {route_err}")
            text += f" (logits vs the plain route max |err| {route_err:.3g}, limit {NN_ROUTE_ATOL})"
        fam_line.append(text)
        del model, ll
    hyb_stages = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in hyb.stage_seconds.items())
    phase(10, f"hybrid path ({len(hyb_corpus)} utterances synthesized in {hyb_synth_s:.1f} s, {len(hyb_batches)} "
          f"batches of {HYB_BATCH}; LstmAm {P} x {H} x {lstm_am.layers}, head gain {HEAD_GAIN:g}): "
          f"{hyb.n_utts / hyb.seconds:.1f} utt/s, RTF {hyb.seconds / hyb.audio_seconds:.6f} ({hyb.seconds:.3f} s "
          f"for {hyb.audio_seconds:.1f} s of audio), WER {hyb.wer:.4f} ({hyb_words} words decoded; no limit, "
          f"random weights); stage ms: {hyb_stages}; launches {hyb_launches}; profiled pass {hyb_prof_wall:.1f} "
          f"ms wall, {hyb_prof_dev:.1f} ms on the device ({100 * hyb_prof_dev / hyb_prof_wall:.1f}% busy), top "
          "device events " + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in hyb_prof_top)
          + f"; plain f32 path WER {hyb_plain.wer:.4f}, transcripts identical on {same:.4f}; bfloat16 and int8 "
          f"transcripts identical to f32 on {agree['bfloat16']:.4f} and {agree['int8']:.4f}; seeded LstmAm logits "
          f"vs f32 max |err| bfloat16 {quant_err['bfloat16']:.3g}, int8 {quant_err['int8']:.3g} (atol/rtol "
          f"{QUANT_TOL}); one batch each: " + "; ".join(fam_line))
    return {"name": "lstm_scan", "route": "cuda", "source": "mogasr_torch/csrc/lstm_scan.cu",
            "replaces": "mogasr/am/lstm_pallas.py:57", "launches": hyb_launches["lstm_scan"],
            "launches_by_path": {"hybrid": hyb_launches["lstm_scan"]},
            "max_abs_err": max(e for (n, d), e in k4_err.items() if d == "float32"),
            "ms": k4_ms["float32"], "plain_ms": k4_plain_ms["float32"],
            "bound_ms": k4_bound["float32"][0], "bound_by": k4_bound["float32"][1], "library_ms": lib_ms,
            "library": "torch.nn.LSTM (cuDNN), the whole layer", "ms_with_input_gemm": layer_ms,
            "cluster": k4_launch["float32"]["cluster"], "ctas": k4_launch["float32"]["ctas"],
            "rows_per_launch": k4_launch["float32"]["rows"],
            "all_rows_at_T": {"ms": k4_all_ms["float32"], "bound_ms": k4_all_bound["float32"][0],
                              "bound_by": k4_all_bound["float32"][1], "bfloat16_ms": k4_all_ms["bfloat16"],
                              "bfloat16_bound_ms": k4_all_bound["bfloat16"][0]},
            "bfloat16": {"launches": bf16_launches, "cluster": k4_launch["bfloat16"]["cluster"],
                         "max_abs_err": max(e for (n, d), e in k4_err.items() if d == "bfloat16"),
                         "ms": k4_ms["bfloat16"], "plain_ms": k4_plain_ms["bfloat16"],
                         "bound_ms": k4_bound["bfloat16"][0], "bound_by": k4_bound["bfloat16"][1],
                         "library_ms": lib_bf16_ms, "library": "torch.nn.LSTM (cuDNN) in bfloat16, the whole layer",
                         "ms_with_input_gemm": layer_bf16_ms}}


def scorer_arm_phases(dev, gmm, fcfg, dcfg, graph, corpus, bcfg, k1_hyps, sfu_exps_per_s) -> list:
    """Phases 11-15: K1w, K5, K2's beam, the decode path through K1w and
    through K5, the PLP front end; returns the kernels line's K1w and K5
    entries."""
    import dataclasses

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda
    from mogasr_torch.am.gmm import gmm_from_numpy, gmm_loglik, quadratic_features, quantize_int8
    from mogasr_torch.data.batching import make_batches
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.frontend.numpy_ref import extract_features_np
    from mogasr_torch.frontend.torch_frontend import make_frontend

    S, K, D = gmm.means.shape
    batch = max(make_batches(corpus, bcfg, fcfg), key=lambda b: b.waves.shape[1])
    fb = pipe.featurize_batch(batch, make_frontend(fcfg, batch.waves.shape[1], dev), dev)
    B, T, _ = fb.feats.shape
    x_main = fb.feats.reshape(B * T, D)
    N = B * T
    rng = np.random.default_rng(SWEEP_SEED)

    def random_gmm(s, k, d, n):
        g = gmm_from_numpy(rng.dirichlet(np.ones(k), size=s).astype(np.float32),
                           rng.standard_normal((s, k, d)).astype(np.float32),
                           (0.5 + rng.random((s, k, d))).astype(np.float32), dev)
        return torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev), g

    x_big, gmm_big = random_gmm(SWEEP_S, SWEEP_K, D, SWEEP_N)
    main_name = f"decode-path batch N={N}"
    big_name = f"{SWEEP_S} x {SWEEP_K} x {D} N={SWEEP_N}"
    inputs = {main_name: (x_main, gmm), big_name: (x_big, gmm_big)}
    wide_features = {f"300 x 8 x {d} N=2000": random_gmm(300, 8, d, 2000) for d in WIDE_FEATURE_DIMS}

    # ---- phase 11: K1w against K1 (bitwise, max mode) and the plain scorer
    k1w_err, k1w_ms, line = {}, {}, []
    for name, (x, g) in {**inputs, **wide_features}.items():
        for dt in ("float32", "bfloat16"):
            k1p = gmm_cuda.kernel_params(g, dt)
            for mode in ("sum", "max"):
                wp = gmm_cuda.kernel_params(g, dt, "wide", mode=mode)

                def wide():
                    return gmm_cuda.gmm_loglik_fused(x, g, dt, mode, params=wp, layout="wide")

                def k1():
                    return gmm_cuda.gmm_loglik_fused(x, g, dt, mode, params=k1p)

                timed_here = (x is x_big) or (dt, mode) == ("bfloat16", "max")
                if timed_here:
                    w_ms, got = timed(wide, 5)
                    c_ms, ref = timed(k1, 5)
                    p_ms, want = timed(lambda: gmm_loglik(x, g, mode=mode, compute_dtype=dt), 2)
                    k1w_ms[(name, dt, mode)] = (w_ms, c_ms, p_ms)
                else:
                    got, ref, want = wide(), k1(), gmm_loglik(x, g, mode=mode, compute_dtype=dt)
                torch.cuda.synchronize()
                if got.shape != (x.shape[0], g.n_states) or not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"K1w {dt}/{mode} on {name}: bad output {tuple(got.shape)}")
                if mode == "max" and not torch.equal(got, ref):
                    raise RuntimeError(f"K1w {dt}/max on {name} is not bitwise equal to K1: max |diff| "
                                       f"{float((got - ref).abs().max())}")
                err = float((got - want).abs().max())
                for kname, out in (("K1w", got), ("K1", ref)):
                    if not torch.allclose(out, want, atol=K1_ATOL, rtol=K1_RTOL):
                        raise RuntimeError(f"{kname} {dt}/{mode} on {name} disagrees with the plain scorer: "
                                           f"max |err| {float((out - want).abs().max())}")
                k1w_err[(name, dt, mode)] = err
                line.append(f"{name} {dt}/{mode} kc={wp.kc} {err:.3g}")
                del got, ref, want
    k1w_main = (main_name, "bfloat16", "max")
    k1w_bound = k1_bound(N, S, K, D, "bfloat16", "max", sfu_exps_per_s)
    big_s, big_k, _ = gmm_big.means.shape
    phase(11, "K1w bitwise equal to K1 in max mode, both within atol %g rtol %g of plain, K1w max |err|: %s; "
          "decode-path batch bf16/max: K1w %.3f ms, K1 %.3f ms, plain %.3f ms (bound %.3f ms by %s); at %s, "
          "K1w vs K1 ms: %s" % (
              K1_ATOL, K1_RTOL, ", ".join(line), *k1w_ms[k1w_main], *k1w_bound[:2], big_name,
              "; ".join(f"{d}/{m} {k1w_ms[(big_name, d, m)][0]:.3f} vs {k1w_ms[(big_name, d, m)][1]:.3f} "
                        f"(plain {k1w_ms[(big_name, d, m)][2]:.3f}, bound "
                        f"{k1_bound(SWEEP_N, big_s, big_k, D, d, m, sfu_exps_per_s)[0]:.3f})"
                        for d in ("float32", "bfloat16") for m in ("sum", "max"))))

    # ---- phase 12: K5 against the plain int8 scorer
    k5_err, line = {}, []
    for name, (x, g) in inputs.items():
        ip = gmm_cuda.kernel_params(g, "int8")
        x2 = quadratic_features(x)
        # the quantization of the same float32 operands, on the card and on the CPU
        cpu_params = gmm_cuda.kernel_params(type(g)(*(a.cpu() for a in g)), "int8")
        for what, a, b in (("qx, sx", quantize_int8(x2, 1), quantize_int8(x2.cpu(), 1)),
                           ("panels, sab", ip[:2], cpu_params[:2])):
            for u, v in zip(a, b):
                if u.dtype != v.dtype or not torch.equal(u.cpu(), v):
                    raise RuntimeError(f"K5 on {name}: {what} made on the card differ from the CPU's")

        def k5():
            return gmm_cuda.gmm_loglik_fused(x, g, "int8", "sum", params=ip)

        if x is x_main:
            k5_ms, got = timed(k5, 5)
            k5_kernel_ms = kernel_device_ms(k5, ("gmm_tc_kernel",), 5)["gmm_tc_kernel"]
            k5_plain_ms, want = timed(lambda: gmm_loglik(x, g, compute_dtype="int8"), 2)
        else:
            got, want = k5(), gmm_loglik(x, g, compute_dtype="int8")
        torch.cuda.synchronize()
        if got.shape != (x.shape[0], g.n_states) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K5 on {name}: bad output {tuple(got.shape)}")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL):
            raise RuntimeError(f"K5 on {name} disagrees with the plain int8 scorer: max |err| {err}")
        k5_err[name] = err
        f32_gap = float((got - gmm_loglik(x, g)).abs().max())
        line.append(f"{name} {err:.3g} (int8 vs float32 sum: max |diff| {f32_gap:.3g})")
        del got, want
    k5_bound = k1_bound(N, S, K, D, "int8", "sum", sfu_exps_per_s)
    phase(12, "K5 quantized operands and int8 panels bitwise equal to the CPU's; within atol %g rtol %g of plain "
          "int8, max |err|: %s; decode-path batch: K5 %.3f ms (%.3f ms on the device), plain %.3f ms; bound %.3f "
          "ms by %s (%s)" % (
              K1_ATOL, K1_RTOL, "; ".join(line), k5_ms, k5_kernel_ms, k5_plain_ms, *k5_bound[:2],
              ", ".join(f"{w} {t:.3f}" for w, t in k5_bound[2].items())))
    del x_big, gmm_big, inputs

    # ---- phase 13: K2 with a beam against the plain Viterbi, bitwise
    ll = gmm_cuda.gmm_loglik_fused(x_main, gmm, "bfloat16", "max").reshape(B, T, S)
    _, graphs = pipe.decode_graphs(graph, B, dev)
    scale = dcfg.acoustic_scale
    beam_ms, got = timed(lambda: viterbi_cuda.viterbi(ll, graphs, fb.n_frames, scale, beam=K2_BEAM), 5)
    plain_beam_ms, want = timed(lambda: vit.viterbi(ll, graphs, fb.n_frames, scale, beam=K2_BEAM), 2)
    exact_ms, exact = timed(lambda: viterbi_cuda.viterbi(ll, graphs, fb.n_frames, scale), 5)
    score_ms, score_only = timed(
        lambda: viterbi_cuda.viterbi(ll, graphs, fb.n_frames, scale, with_backtrace=False), 5)
    torch.cuda.synchronize()
    for field in ("path", "entered", "score"):
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"K2 with beam {K2_BEAM}: {field} differs from the plain Viterbi")
    if not torch.equal(score_only.score, exact.score) or bool(score_only.path.any()):
        raise RuntimeError("K2 without a backtrace: its score differs from the full decode's, or its path is not 0")
    pruned = int((got.path != exact.path).any(dim=1).sum())
    phase(13, f"K2 with beam {K2_BEAM:g} bitwise equal to plain on the decode-path batch B={B} T={T} "
          f"J={graph.n_states}: {beam_ms:.3f} ms (plain {plain_beam_ms:.3f} ms); without a beam {exact_ms:.3f} "
          f"ms, without a backtrace {score_ms:.3f} ms (score equal); the beam changed the path of {pruned} of "
          f"{B} rows")
    del ll, got, want, exact, score_only, fb, x_main

    # ---- phase 14: the decode path through K1w (bf16/max) and K5 (int8/sum)
    def decode(**kw):
        return pipe.decode_corpus(corpus, gmm, graph, fcfg, dcfg, bcfg, dev, **kw)

    arms = {"K1w bfloat16/max": dict(compute_dtype="bfloat16", layout="wide"),
            "K5 int8/sum": dict(compute_dtype="int8", mode="sum")}
    plain_sum = decode(compute_dtype="float32", mode="sum", use_kernels=False)
    arm_launches, line = {}, []
    for name, kw in arms.items():
        decode(**kw)
        gmm_cuda.LAUNCHES = gmm_cuda.WIDE_LAUNCHES = gmm_cuda.INT8_LAUNCHES = viterbi_cuda.LAUNCHES = 0
        torch.cuda.synchronize()
        run = decode(**kw)
        launches = {"gmm_score": gmm_cuda.LAUNCHES, "gmm_score_wide": gmm_cuda.WIDE_LAUNCHES,
                    "gmm_score_int8": gmm_cuda.INT8_LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES}
        arm_launches[name] = launches
        own = "gmm_score_wide" if "K1w" in name else "gmm_score_int8"
        if launches[own] == 0 or launches["viterbi"] == 0 or launches["gmm_score"] != 0:
            raise RuntimeError(f"the {name} decode did not go through its kernels alone: {launches}")
        if run.n_utts != len(corpus) or not np.isfinite(run.scores).all():
            raise RuntimeError(f"{name} decode: {run.n_utts} of {len(corpus)} utterances, finite scores "
                               f"{bool(np.isfinite(run.scores).all())}")
        if run.wer > MAX_WER:
            raise RuntimeError(f"{name} decode WER {run.wer:.4f} > {MAX_WER}")
        same_k1 = sum(a == b for a, b in zip(run.hyps, k1_hyps)) / len(k1_hyps)
        same_plain = sum(a == b for a, b in zip(run.hyps, plain_sum.hyps)) / len(k1_hyps)
        if "K1w" in name and same_k1 != 1.0:
            raise RuntimeError(f"the K1w decode's transcripts differ from the K1 decode's on {1 - same_k1:.4f}")
        if same_plain < MIN_AGREEMENT:
            raise RuntimeError(f"the {name} decode agrees with the plain f32/sum path on {same_plain:.4f}")
        stages = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in run.stage_seconds.items())
        line.append(f"{name}: WER {run.wer:.4f}, {run.n_utts / run.seconds:.1f} utt/s, RTF "
                    f"{run.seconds / run.audio_seconds:.6f} ({run.seconds:.3f} s); stage ms: {stages}; launches "
                    f"{launches}; transcripts identical to the K1 run on {same_k1:.4f}, to the plain f32/sum "
                    f"path on {same_plain:.4f}")
    phase(14, f"decode path through the scorer's arms, {len(corpus)} utterances (plain f32/sum path WER "
          f"{plain_sum.wer:.4f}): " + "; ".join(line))

    # ---- phase 15: the PLP front end on the card against the NumPy oracle
    pcfg = dataclasses.replace(fcfg, feature_type="plp")
    plp_err = 0.0
    for utt_id, wave, _words in corpus[:4]:
        feats, nf = make_frontend(pcfg, len(wave), dev)(torch.as_tensor(wave)[None], torch.as_tensor([len(wave)]))
        got = feats[0, : int(nf[0])].cpu().numpy()
        want = extract_features_np(wave, pcfg)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"PLP front end {utt_id}: shape {got.shape} vs oracle {want.shape}")
        plp_err = max(plp_err, float(np.abs(got - want).max()))
    if plp_err > FRONTEND_ATOL:
        raise RuntimeError(f"PLP front end disagrees with the NumPy oracle: max |err| {plp_err}")
    phase(15, f"PLP front end matches numpy_ref on 4 utterances: max |err| {plp_err:.3g} (atol {FRONTEND_ATOL})")

    return [
        {"name": "gmm_score_wide", "route": "cuda", "source": "mogasr_torch/csrc/gmm_wide.cu",
         "replaces": "mogasr/am/gmm_pallas.py:107", "launches": arm_launches["K1w bfloat16/max"]["gmm_score_wide"],
         "launches_by_path": {"decode_wide": arm_launches["K1w bfloat16/max"]["gmm_score_wide"]},
         "max_abs_err": k1w_err[k1w_main], "ms": k1w_ms[k1w_main][0], "plain_ms": k1w_ms[k1w_main][2],
         "bound_ms": k1w_bound[0], "bound_by": k1w_bound[1], "library_ms": None,
         "k1_ms_same_inputs": k1w_ms[k1w_main][1]},
        {"name": "gmm_score_int8", "route": "cuda", "source": "mogasr_torch/csrc/gmm_score.cu",
         "replaces": "mogasr/am/gmm_pallas.py:48", "launches": arm_launches["K5 int8/sum"]["gmm_score_int8"],
         "launches_by_path": {"decode_int8": arm_launches["K5 int8/sum"]["gmm_score_int8"]},
         "max_abs_err": k5_err[main_name], "ms": k5_ms, "device_ms": k5_kernel_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "library_ms": None},
    ]


def _same_alternatives(got, want) -> bool:
    """Two ranked alternative lists agree: the same words (but for one within
    CONF_ATOL of the 0.01 cut-off), posteriors within CONF_ATOL, and the
    words whose posteriors are more than CONF_ATOL apart in the same order."""
    a, b = dict(got), dict(want)
    if any(abs(a.get(w, b.get(w)) - 0.01) > CONF_ATOL for w in a.keys() ^ b.keys()):
        return False
    rank = {w: i for i, (w, _p) in enumerate(got)}
    common = [w for w, _p in want if w in a]
    for i, w in enumerate(common):
        if abs(a[w] - b[w]) > CONF_ATOL:
            return False
        if any(b[w] - b[v] > CONF_ATOL and rank[w] > rank[v] for v in common[i + 1:]):
            return False
    return True


def lm_lattice_phases(dev, gmm, fcfg, dcfg, tied, graph, corpus, bcfg, train_texts, loop_wer, k3_dev) -> dict:
    """Phases 19 (LM decoding at full width) and 20 (lattices, confidence and
    n-best). ``k3_dev`` holds K3's device times on the decode path's widest
    batch, profiled in phase 3. Returns the launches of their paths and K3's
    numbers at that batch's shape for the kernels line."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda
    from mogasr_torch.data.batching import make_batches
    from mogasr_torch.decoder import confusion as cn
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder import forward_backward as fbd
    from mogasr_torch.decoder import lattice as lat_mod
    from mogasr_torch.decoder import lm_viterbi as lv
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.hmm import triphone as tri
    from mogasr_torch.lm import ngram

    def zero_counts():
        gmm_cuda.LAUNCHES = viterbi_cuda.LAUNCHES = 0
        fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = 0
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES, "fb_forward": fb_cuda.FWD_LAUNCHES,
                "fb_backward": fb_cuda.BWD_LAUNCHES, "fb_combine": fb_cuda.COMBINE_LAUNCHES}

    def words_of(toks):
        return [[w.lower() for w in t if w not in pipe.DROP_TOKENS] for t in toks]

    # ---- phase 19: LM decoding of the held-out set on phase 5's emissions
    toks = sorted(set(graph.labels))
    lms = {"bigram": ngram.estimate_bigram(train_texts, toks), "kneser-ney": ngram.estimate_bigram_kn(train_texts, toks)}
    graph0 = tri.word_loop_graph_cd(tied, insertion_penalty=0.0)
    dcfg0 = type(dcfg)(acoustic_scale=dcfg.acoustic_scale, word_insertion_penalty=0.0)
    uniform = ngram.uniform_bigram(graph0.labels)
    batches = list(make_batches(corpus, bcfg, fcfg))
    frontends = pipe.frontends_for(batches, fcfg, dev)
    params = gmm_cuda.kernel_params(gmm, "bfloat16", mode="max")
    graphs = pipe.decode_graphs(graph, bcfg.batch_size, dev)
    graphs0 = pipe.decode_graphs(graph0, bcfg.batch_size, dev)

    def lm_decode(fb, ll, lm, with_lattice=False):
        return lv.viterbi_lm(ll, graph, lm, fb.n_frames, acoustic_scale=dcfg.acoustic_scale,
                             insertion_penalty=dcfg.word_insertion_penalty, with_lattice=with_lattice)

    def add_counts(total):
        for k, n in counts().items():
            total[k] = total.get(k, 0) + n

    # the LM decode path (K1, then the recursion, which launches no kernel of
    # the port) and the checks beside it (K2 decodes) are counted apart
    t_start = time.perf_counter()
    scored, refs = [], []
    hyps = {name: [] for name in ("loop", *lms)}
    lm_wall = {name: 0.0 for name in lms}
    lm_launches, check_launches = {}, {}
    uniform_diff, n_frames_total = 0, 0
    for batch in batches:
        zero_counts()
        fb = pipe.featurize_batch(batch, frontends[batch.waves.shape[1]], dev)
        ll = pipe.score_batch(fb.feats, gmm, True, "bfloat16", "max", params)
        # (b) the two bigrams
        for name, lm in lms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lv.path_to_tokens_lm(lm_decode(fb, ll, lm), graph)
            lm_wall[name] += time.perf_counter() - t0
            hyps[name] += words_of(out[: fb.size])
        add_counts(lm_launches)
        zero_counts()
        scored.append((fb, ll))
        refs += [[w.lower() for w in words] for words in fb.words[: fb.size]]
        n_frames_total += int(fb.n_frames.sum())
        # (a) a uniform bigram without insertion penalty decodes as K2 over the word loop
        k2_toks = pipe.decode_batch(fb, ll, graph0, dcfg0, drop_tokens=(), graphs=graphs0)
        u_toks = lv.path_to_tokens_lm(lv.viterbi_lm(ll, graph0, uniform, fb.n_frames,
                                                    acoustic_scale=dcfg.acoustic_scale), graph0)[: fb.size]
        uniform_diff += sum(a != b for a, b in zip(u_toks, k2_toks))
        # (b) the loop decode beside them
        hyps["loop"] += [[w.lower() for w in t] for t in pipe.decode_batch(fb, ll, graph, dcfg, graphs=graphs)]
        add_counts(check_launches)
    lm_path_s = time.perf_counter() - t_start
    if uniform_diff:
        raise RuntimeError(f"the uniform-LM decode differs from K2's on {uniform_diff} utterances")
    if lm_launches["gmm_score"] == 0 or any(n for k, n in lm_launches.items() if k != "gmm_score"):
        raise RuntimeError(f"the LM decode path must launch K1 and no other kernel of the port: {lm_launches}")
    if check_launches["viterbi"] == 0:
        raise RuntimeError(f"the uniform-LM check and the loop decode did not go through K2: {check_launches}")
    wers = {name: corpus_wer(refs, h)[0] for name, h in hyps.items()}
    if len(refs) != len(corpus) or any(w > MAX_WER for w in wers.values()):
        raise RuntimeError(f"LM decoding of {len(refs)} utterances: WER {wers} (limit {MAX_WER})")
    # (c) the card against the CPU on a slice of the widest batch
    fb_w, ll_w = max(scored, key=lambda p: p[1].shape[1])
    B, T, _ = ll_w.shape
    rows = slice(0, LM_CPU_ROWS)
    part = pipe.FeatBatch(fb_w.utt_ids[rows], fb_w.feats[rows], fb_w.n_frames[rows], fb_w.words[rows])
    got = lm_decode(part, ll_w[rows], lms["bigram"])
    want = lv.viterbi_lm(ll_w[rows].cpu(), graph, lms["bigram"], part.n_frames.cpu(),
                         acoustic_scale=dcfg.acoustic_scale, insertion_penalty=dcfg.word_insertion_penalty)
    score_rel = float(((got.score.cpu().double() - want.score.double()) / want.score.double().abs()).abs().max())
    if not (torch.equal(got.path.cpu(), want.path) and torch.equal(got.entered.cpu(), want.entered)) \
            or score_rel > LM_SCORE_RTOL:
        raise RuntimeError(f"viterbi_lm on the card differs from the CPU on {LM_CPU_ROWS} rows (score rel "
                           f"{score_rel:.3g})")
    # K3 at the decode batch's shape (its general arm over the word loop),
    # timed before the recursion's long profile below, printed in phase 20;
    # its device times are phase 3's, on the same batch
    graphs_w = graphs[1]
    if tuple(k3_dev["shape"]) != (B, T):
        raise RuntimeError(f"phase 3 profiled K3 on a B, T = {k3_dev['shape']} batch, not the widest one {B, T}")

    def k3():
        return fb_cuda.forward_backward(ll_w, graphs_w, fb_w.n_frames, acoustic_scale=dcfg.acoustic_scale)

    k3_call = per_call_ms(k3, 10)
    k3_bounds = fb_bounds(graphs_w, fb_w.n_frames, T)
    emit_graph = fbd.gather_emissions(ll_w, graphs_w["emit_id"], dcfg.acoustic_scale)
    plain_fwd_ms, (alphas, loglik) = timed(lambda: fbd.forward_pass(emit_graph, graphs_w, fb_w.n_frames), 1)
    plain_bwd_ms, _ = timed(lambda: fbd.backward_pass(emit_graph, graphs_w, fb_w.n_frames, alphas, loglik), 1)
    k3_loglik = k3().loglik
    k3_err = float((k3_loglik - loglik).abs().max())
    if not torch.allclose(k3_loglik, loglik, rtol=FB_LOGLIK_RTOL, atol=0.0):
        raise RuntimeError(f"K3 at B={B} T={T}: loglik off by {k3_err} from plain f32 (rtol {FB_LOGLIK_RTOL})")
    del k3_loglik
    del emit_graph, alphas
    k3_entry = {"B": B, "T": T, "J": graph.n_states, "arm": "general", "pair_ms": k3_call, **k3_dev["device_ms"],
                "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms, "loglik_max_abs_err": k3_err,
                "bounds": k3_bounds, "launches_per_batch": 2}
    # (d) the recursion's time and device work on the widest batch
    lm_ms, _ = timed(lambda: lm_decode(fb_w, ll_w, lms["bigram"]), 3)
    lat_ms, _ = timed(lambda: lm_decode(fb_w, ll_w, lms["bigram"], True), 3)
    prof_wall, prof_dev, prof_top, prof_all = device_profile(lambda: lm_decode(fb_w, ll_w, lms["bigram"]), names=("",))
    lm_events = prof_all[""][1]
    k2_ms, _ = timed(lambda: viterbi_cuda.viterbi(ll_w, graphs[1], fb_w.n_frames, acoustic_scale=dcfg.acoustic_scale),
                     5)
    phase(19, f"LM decoding of the {len(refs)} held-out utterances ({len(batches)} batches, {n_frames_total} frames) on "
          f"K1 bf16/max emissions, bigrams over {len(toks)} tokens from the {len(train_texts)} transcripts of phase 8's "
          f"corpus: WER loop (K2) {wers['loop']:.4f} (phase 5: {loop_wer:.4f}), bigram {wers['bigram']:.4f}, Kneser-Ney "
          f"{wers['kneser-ney']:.4f} (limit {MAX_WER}); uniform bigram without insertion penalty = K2's transcripts on "
          f"all {len(refs)}; the card = the CPU on {LM_CPU_ROWS} rows of the B={B} T={T} batch (path, entered bitwise, "
          f"score max rel {score_rel:.3g}); on that batch viterbi_lm {lm_ms:.1f} ms ({lm_ms / T:.3f} ms a frame; with "
          f"the lattice {lat_ms:.1f} ms) against K2's {k2_ms:.3f} ms; profiled: {prof_wall:.1f} ms wall, {prof_dev:.1f} "
          f"ms on the device ({100 * prof_dev / prof_wall:.1f}% busy), {lm_events} device events "
          f"({lm_events / T:.1f} a frame), top " + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof_top)
          + f"; wall s over the corpus: bigram {lm_wall['bigram']:.2f}, Kneser-Ney {lm_wall['kneser-ney']:.2f}, "
          f"the phase {lm_path_s:.1f}; launches: LM decode {lm_launches}, uniform-LM check and loop decode "
          f"{check_launches}")

    # ---- phase 20: lattices, confidence and n-best
    lm = lms["bigram"]
    t0 = time.perf_counter()
    lats, _res = pipe.decode_batch_lattices(fb_w, ll_w, graph, lm, dcfg, prune_beam=LAT_PRUNE_BEAM)
    lat_call_s = time.perf_counter() - t0
    _r, lattice = lm_decode(fb_w, ll_w, lm, True)
    arrays = [a.cpu().numpy() for a in lattice]
    nf_host = fb_w.n_frames.cpu().numpy()
    t0 = time.perf_counter()
    lats_again = lat_mod.lattices_from_pass(*arrays, nf_host, graph.labels, prune_beam=LAT_PRUNE_BEAM)
    host_s = time.perf_counter() - t0
    del lattice, arrays
    n_check = min(LAT_CHECK_UTTS, fb_w.size)
    part = pipe.FeatBatch(fb_w.utt_ids[:n_check], fb_w.feats[:n_check].cpu(), fb_w.n_frames[:n_check].cpu(),
                          fb_w.words[:n_check])
    cpu_lats, _ = pipe.decode_batch_lattices(part, ll_w[:n_check].cpu(), graph, lm, dcfg, prune_beam=LAT_PRUNE_BEAM)
    lat_err = 0.0
    for a, b, c in zip(lats, cpu_lats, lats_again):
        if a.n_frames != b.n_frames or [(x.start, x.end, x.chain) for x in a.arcs] != \
                [(x.start, x.end, x.chain) for x in b.arcs] or a.arcs != c.arcs:
            raise RuntimeError("a lattice of the card differs from the CPU's arc for arc")
        lat_err = max([lat_err] + [abs(x.score - y.score) for x, y in zip(a.arcs, b.arcs)])
    if lat_err > LAT_SCORE_ATOL:
        raise RuntimeError(f"lattice arc scores: card vs CPU {lat_err:.3g} > {LAT_SCORE_ATOL}")
    trigram = ngram.estimate_trigram(train_texts, toks)
    t0 = time.perf_counter()
    second = {
        "bigram 1-best (the lattice pass)": [lat_mod.rescore_lattice(x, lm)[0] for x in lats[:n_check]],
        "trigram rescore": [lat_mod.rescore_lattice(x, trigram)[0] for x in lats[:n_check]],
        "trigram 3-best, top": [(lat_mod.lattice_nbest(x, trigram, 3) or [([], 0.0)])[0][0] for x in lats[:n_check]],
        "consensus (CN)": [cn.consensus_decode(cn.confusion_network(x, trigram))[0] for x in lats[:n_check]],
        "N-best MBR": [cn.mbr_nbest_decode(x, trigram, n=16)[0] for x in lats[:n_check]],
    }
    second_s = time.perf_counter() - t0
    refs_w = [[w.lower() for w in words] for words in fb_w.words[:n_check]]
    second_wer = {k: corpus_wer(refs_w, words_of(v))[0] for k, v in second.items()}
    n_arcs = [len(x.arcs) for x in lats]

    # confidence and n-best over the 768 utterances, K2 + K3 and plain
    zero_counts()
    conf, nbest = [], []
    for fb, ll in scored:
        conf += pipe.decode_batch_with_confidence(fb, ll, graph, dcfg)
        nbest += pipe.decode_batch_nbest(fb, ll, graph, dcfg)
    conf_launches = counts()
    arms = fb_cuda.LAST_ARMS.tolist()
    if min(conf_launches["viterbi"], conf_launches["fb_forward"], conf_launches["fb_backward"]) == 0 or \
            set(arms[0]) | set(arms[1]) != {fb_cuda.ARM_GENERAL}:
        raise RuntimeError(f"confidence path launches {conf_launches}, K3 arms {arms}")
    conf_p, nbest_p = [], []
    for fb, ll in scored:
        conf_p += pipe.decode_batch_with_confidence(fb, ll, graph, dcfg, use_kernels=False)
        nbest_p += pipe.decode_batch_nbest(fb, ll, graph, dcfg, use_kernels=False)
    if [[w for w, _c in row] for row in conf] != [[w for w, _c in row] for row in conf_p]:
        raise RuntimeError("confidence: the words through K2 + K3 differ from the plain path's")
    conf_err = max([0.0] + [abs(c - d) for r, s in zip(conf, conf_p) for (_w, c), (_v, d) in zip(r, s)])
    if [[(d["best"], d["span"]) for d in r] for r in nbest] != [[(d["best"], d["span"]) for d in r] for r in nbest_p] \
            or not all(_same_alternatives(d["alternatives"], e["alternatives"])
                       for r, s in zip(nbest, nbest_p) for d, e in zip(r, s)):
        raise RuntimeError("n-best: the kernels' alternatives differ from the plain path's")
    if conf_err > CONF_ATOL:
        raise RuntimeError(f"confidences: K2 + K3 vs plain max |diff| {conf_err:.3g} > {CONF_ATOL}")
    n_words = sum(len(r) for r in conf)
    kd = k3_dev["device_ms"]
    mean_conf = sum(c for r in conf for _w, c in r) / max(n_words, 1)
    hyp_conf = [[w.lower() for w, _c in r] for r in conf]
    conf_wer = corpus_wer(refs, hyp_conf)[0]
    phase(20, f"lattices: decode_batch_lattices on the B={B} T={T} batch, prune beam {LAT_PRUNE_BEAM:g}: "
          f"{lat_call_s:.2f} s ({sum(n_arcs)} arcs for {fb_w.size} utterances, {min(n_arcs)}-{max(n_arcs)} each), "
          f"lattices_from_pass {host_s:.3f} s on the host; {n_check} utterances' lattices = the CPU's arc for arc "
          f"(scores max |diff| {lat_err:.3g}, limit {LAT_SCORE_ATOL}); on them (host {second_s:.2f} s) WER "
          + ", ".join(f"{k} {v:.4f}" for k, v in second_wer.items())
          + f"; confidence and n-best on the {len(conf)} utterances through K2 + K3 (arm general both ways): words "
          f"= the plain path's, confidences max |diff| {conf_err:.3g} (limit {CONF_ATOL}), alternatives agree; "
          f"{n_words} words, mean confidence {mean_conf:.4f}, WER {conf_wer:.4f}; launches {conf_launches}; K3 at "
          f"B={B} T={T} J={graph.n_states}: K3f + K3b + combine {k3_call:.3f} ms a call in a run of 10 (bound "
          f"{k3_bounds['pair'][0]:.4f} ms by {k3_bounds['pair'][1]}), K3f {kd['fb_forward_kernel']:.3f} ms (bound "
          f"{k3_bounds['fwd'][0]:.4f}), K3b {kd['fb_backward_kernel']:.3f} ms (bound {k3_bounds['bwd'][0]:.4f}), "
          f"combine {kd['fb_combine_kernel']:.3f} ms (bound {k3_bounds['combine'][0]:.4f}) (profiled in phase 3); "
          f"plain forward "
          f"{plain_fwd_ms:.1f} ms, backward {plain_bwd_ms:.1f} ms; loglik max |err| {k3_err:.3g}")
    del scored, ll_w
    return {"lm_decode": lm_launches, "lm_check_decodes": check_launches, "confidence": conf_launches,
            "k3_decode_batch": k3_entry}


def decode_cli_phase(dev: torch.device) -> str:
    """Phase 21: ``python -m mogasr_torch.cli.decode`` (the bundle's LM path on
    a v2 corpus; the lattice flags, with --lattice-out, on the small lexicon)
    and ``python -m mogasr_torch.cli.search``, all three at once. Each must
    exit 0 and log its record; the lattice archive must read back. Returns
    the phase's line."""
    import shutil

    from mogasr_torch.decoder.lattice import read_lattices

    work = os.path.join(ROOT, "build", "chip_smoke_decode_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = {**os.environ, "PYTHONPATH": ROOT}
    runs = {}
    for i, (name, args) in enumerate([*CLI_DECODE_RUNS.items(), ("search", CLI_SEARCH_ARGS)]):
        d = os.path.join(work, f"run{i}")
        module = "mogasr_torch.cli.search" if name == "search" else "mogasr_torch.cli.decode"
        extra = ["--lattice-out", os.path.join(d, "lats.txt")] if name == "lattice flags" else []
        cmd = [sys.executable, "-m", module, *args, *extra, "--run-dir", d, "--out", os.path.join(d, "out.jsonl"),
               "--device", str(dev)]
        runs[name] = (d, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
    t0 = time.perf_counter()
    results = {}
    try:
        for name, (d, proc) in runs.items():
            out, err = proc.communicate(timeout=max(CLI_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if proc.returncode != 0:
                raise RuntimeError(f"the CLI twin ({name}) failed ({proc.returncode}): {err[-2000:]}")
            records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            with open(os.path.join(d, "out.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            results[name] = (records, lines, time.perf_counter() - t0)
    finally:
        for _d, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    text = []
    for name, (records, lines, secs) in results.items():
        stage = "kws" if name == "search" else "decode"
        rec = [r for r in records if r.get("stage") == stage]
        if len(rec) != 1 or not lines:
            raise RuntimeError(f"the CLI twin ({name}) printed {records} and wrote {len(lines)} lines")
        rec = rec[0]
        if name == "search":
            text.append(f"search ({' '.join(CLI_SEARCH_ARGS)}): {rec['hits']} hits in {rec['utts']} utterances")
            continue
        if name == "lattice flags":
            lats = read_lattices(os.path.join(runs[name][0], "lats.txt"))
            if len(lats) != rec["utts"] or not all(lat.arcs for lat in lats.values()) or \
                    not all(len(x["nbest"]) > 0 for x in lines):
                raise RuntimeError(f"the CLI twin's lattice archive or N-best lists are empty: {len(lats)} lattices")
            extra = f", its lattice archive read back ({sum(len(x.arcs) for x in lats.values())} arcs)"
        else:
            extra = ""
        text.append(f"decode {name} ({' '.join(CLI_DECODE_RUNS[name])}): {rec['utts']} utterances, WER "
                    f"{rec['wer']:.4f}, {rec['wall_sec']:.2f} s in its timer{extra}")
    shutil.rmtree(work, ignore_errors=True)
    return "the CLI twins, run at once, exited 0 in " + f"{max(r[2] for r in results.values()):.1f} s: " + "; ".join(text)


def write_cli_corpora(work: str, corpus, lexicon) -> dict:
    """Phase 22's inputs: ``corpus`` as 16-bit WAV with a JSONL manifest, its
    first CLI_FLAC_UTTS utterances as FLAC in LibriSpeech layout, and the
    lexicon as a Kaldi-style lexicon.txt; returns their paths and the
    seconds each took."""
    import types

    from mogasr_torch.data.audio import write_wav
    from mogasr_torch.data.librispeech import write_fixture_corpus
    from mogasr_torch.data.manifest import write_manifest

    paths = {"wav_dir": os.path.join(work, "wav"), "manifest": os.path.join(work, "corpus.jsonl"),
             "librispeech": os.path.join(work, "LibriSpeech"), "lexicon": os.path.join(work, "lexicon.txt")}
    os.makedirs(paths["wav_dir"])
    t0 = time.perf_counter()
    for utt_id, wave, _words in corpus:
        write_wav(os.path.join(paths["wav_dir"], f"{utt_id}.wav"), wave, 16000)
    write_manifest(paths["manifest"], ({"audio": f"wav/{u}.wav", "text": " ".join(ws), "id": u} for u, _w, ws in corpus))
    t1 = time.perf_counter()
    write_fixture_corpus(paths["librispeech"], "dev-clean",
                         [types.SimpleNamespace(wave=w, sample_rate=16000, words=ws)
                          for _u, w, ws in corpus[:CLI_FLAC_UTTS]], fmt="flac")
    t2 = time.perf_counter()
    with open(paths["lexicon"], "w") as f:
        for word in lexicon.words:
            for pron in lexicon.variants[word]:
                f.write(f"{word.upper()} {' '.join(pron)}\n")
    return {**paths, "wav_s": t1 - t0, "flac_s": t2 - t1}


def gmm_cli_phase(dev: torch.device, corpus, lexicon, mono_ckpt: str, plain_wer: float):
    """Phase 22: ``python -m mogasr_torch.cli.{features,score,align,eval}`` on
    real corpora, all at once: phase 5's held-out utterances as WAV with a
    manifest, CLI_FLAC_UTTS of them as FLAC in LibriSpeech layout (the native
    decoder must load). features --check-parity --write-ark on the FLAC
    corpus (parity passes, the ark reads back); score and align with phase
    16's monophone model (the port's checkpoint) on the WAV manifest, one
    utterance's matrix held to the plain scorer at K1's tolerance and one
    batch's pdfs bitwise to ``align_batch(use_kernels=False)`` on the same
    features; eval --bundle on the WAV manifest (WER limit) and on the FLAC
    corpus (the same transcripts), eval --consensus on the small lexicon.
    Then score, align and eval in this process on CLI_COUNT_UTTS utterances
    with the launch counts set to 0 before and read after. Returns the
    phase's line and the counts."""
    import shutil

    from mogasr_torch import native
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda, lstm_cuda
    from mogasr_torch.am.gmm import gmm_loglik
    from mogasr_torch.cli import align as cli_align
    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.cli import features as cli_features
    from mogasr_torch.cli import score as cli_score
    from mogasr_torch.cli.common import load_or_random_gmm
    from mogasr_torch.config import BatchConfig, FrontendConfig, TopologyConfig
    from mogasr_torch.data.kaldi_io import read_ark_t
    from mogasr_torch.data.manifest import read_manifest
    from mogasr_torch.decoder import fb_cuda, viterbi_cuda
    from mogasr_torch.hmm.lexicon import load_lexicon
    from mogasr_torch.hmm.topology import build_topology

    work = os.path.join(ROOT, "build", "chip_smoke_gmm_cli")
    files = write_cli_corpora(os.path.join(work, "data"), corpus, lexicon)
    lex = load_lexicon(files["lexicon"])
    if (lex.phones, lex.words, lex.prons) != (lexicon.phones, lexicon.words, lexicon.prons):
        raise RuntimeError("the lexicon file does not read back as the bundle's lexicon")
    lib = native.load_flac_lib()
    if lib is None or not os.path.samefile(lib._name, native.library_path("flac_native")):
        raise RuntimeError(f"the native FLAC decoder did not build and load: {lib}")
    wav = ["--manifest", files["manifest"], "--lexicon", files["lexicon"]]
    flac = ["--librispeech-root", files["librispeech"], "--split", "dev-clean", "--lexicon", files["lexicon"]]
    ark = os.path.join(work, "feats.ark")
    runs = {
        "features": ("features", flac + ["--check-parity", "--write-ark", ark]),
        "score": ("score", wav + ["--gmm-ckpt", mono_ckpt, "--out", os.path.join(work, "score.npz")]),
        "align": ("align", wav + ["--gmm-ckpt", mono_ckpt, "--out", os.path.join(work, "align.jsonl")]),
        "eval wav": ("eval", wav + ["--bundle", BUNDLE]),
        "eval flac": ("eval", flac + ["--bundle", BUNDLE]),
        "eval consensus": ("eval", ["--synthetic", str(CLI_CONSENSUS_UTTS), "--synthetic-seed", "34", "--consensus"]),
    }
    # one intra-op thread each: six processes share the host's cores
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = {}
    t0 = time.perf_counter()
    for name, (module, args) in runs.items():
        run_dir = os.path.join(work, name.replace(" ", "_"))
        cmd = [sys.executable, "-m", f"mogasr_torch.cli.{module}", *args, "--run-dir", run_dir, "--device", str(dev)]
        procs[name] = (run_dir, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    try:
        # meanwhile, in this process: the same features as the twins' (the
        # same batches on the same card), and the launch counts
        gmm = load_or_random_gmm(argparse.Namespace(gmm_ckpt=mono_ckpt), 39, dev)
        topo = build_topology(lex, TopologyConfig())
        if topo.n_pdfs != gmm.n_states:
            raise RuntimeError(f"phase 16's monophone model has {gmm.n_states} states, the topology {topo.n_pdfs}")
        fbs = pipe.featurize(read_manifest(files["manifest"]), FrontendConfig(), BatchConfig(), dev)
        gmm_cuda.LAUNCHES = gmm_cuda.WIDE_LAUNCHES = gmm_cuda.INT8_LAUNCHES = viterbi_cuda.LAUNCHES = 0
        fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = lstm_cuda.LAUNCHES = 0
        torch.cuda.synchronize()
        count_dir = os.path.join(work, "counted")
        few = wav + ["--max-utts", str(CLI_COUNT_UTTS), "--device", str(dev)]
        cli_features.main(few + ["--run-dir", os.path.join(count_dir, "features")])
        cli_score.main(few + ["--gmm-ckpt", mono_ckpt, "--run-dir", os.path.join(count_dir, "score")])
        cli_align.main(few + ["--gmm-ckpt", mono_ckpt, "--run-dir", os.path.join(count_dir, "align")])
        cli_eval.main(few + ["--bundle", BUNDLE, "--run-dir", os.path.join(count_dir, "eval")])
        torch.cuda.synchronize()
        launches = {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES,
                    "fb_forward": fb_cuda.FWD_LAUNCHES, "fb_backward": fb_cuda.BWD_LAUNCHES,
                    "fb_combine": fb_cuda.COMBINE_LAUNCHES, "gmm_score_wide": gmm_cuda.WIDE_LAUNCHES,
                    "gmm_score_int8": gmm_cuda.INT8_LAUNCHES, "lstm_scan": lstm_cuda.LAUNCHES}
        if min(launches["gmm_score"], launches["viterbi"]) == 0 or \
                any(v for k, v in launches.items() if k not in ("gmm_score", "viterbi")):
            raise RuntimeError(f"the CLI path's launches: {launches} (K1 and K2 only)")
        results = {}
        for name, (run_dir, proc) in procs.items():
            out, err = proc.communicate(timeout=max(CLI_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if proc.returncode != 0:
                raise RuntimeError(f"the CLI twin ({name}) failed ({proc.returncode}): {err[-2000:]}")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                results[name] = [json.loads(line) for line in f]
        all_s = time.perf_counter() - t0
    finally:
        for _run_dir, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)

    def record(name, stage):
        recs = [r for r in results[name] if r["stage"] == stage]
        if len(recs) != 1:
            raise RuntimeError(f"the CLI twin ({name}) logged {results[name]}")
        return recs[0]

    # features: parity against the NumPy oracle, the ark back
    feat, parity = record("features", "features"), record("features", "parity")
    back = dict(read_ark_t(ark))
    if not parity["pass"] or feat["utts"] != CLI_FLAC_UTTS or len(back) != CLI_FLAC_UTTS or \
            sum(len(m) for m in back.values()) != feat["frames"]:
        raise RuntimeError(f"features: {feat}, {parity}, ark of {len(back)} utterances")
    # score: one utterance's matrix against the plain scorer on the same features
    dump = np.load(os.path.join(work, "score.npz"))
    fb = max(fbs, key=lambda f: f.feats.shape[1])
    i = int(torch.argmax(fb.n_frames))
    got = torch.as_tensor(dump[fb.utt_ids[i]], device=dev)
    want = gmm_loglik(fb.feats[i, : int(fb.n_frames[i])], gmm, mode="sum", compute_dtype="float32")
    score_err = float((got - want).abs().max())
    if len(dump.files) != len(corpus) or not torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL):
        raise RuntimeError(f"score: {len(dump.files)} matrices; {fb.utt_ids[i]} {score_err:.3g} from plain")
    # align: one batch's pdfs bitwise the plain path's
    with open(os.path.join(work, "align.jsonl")) as f:
        ali = {r["utt_id"]: r for r in map(json.loads, f)}
    _res, labels, _g = pipe.align_batch(fb, gmm, lex, topo, use_kernels=False)
    labels, nf = labels.cpu().numpy(), fb.n_frames.cpu().numpy()
    diff = [u for b, u in enumerate(fb.utt_ids) if ali[u]["pdfs"] != labels[b, : nf[b]].tolist()]
    if len(ali) != len(corpus) or diff:
        raise RuntimeError(f"align: {len(ali)} alignments; pdfs differ from the plain path on {diff}")
    # eval: WER limit on the WAV corpus, the FLAC corpus's transcripts equal
    ev_wav, ev_flac, ev_cn = record("eval wav", "eval"), record("eval flac", "eval"), record("eval consensus", "eval")
    if ev_wav["utts"] != len(corpus) or ev_wav["wer"] > MAX_WER:
        raise RuntimeError(f"eval --bundle on the WAV corpus: {ev_wav} (WER limit {MAX_WER})")
    hyps = {}
    for name in ("eval wav", "eval flac"):
        with open(os.path.join(work, name.replace(" ", "_"), "eval_hyps.jsonl")) as f:
            hyps[name] = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
    # write_fixture_corpus names the i-th utterance 0-0-<i>
    flac_ids = [f"0-0-{i:04d}" for i in range(CLI_FLAC_UTTS)]
    if [hyps["eval flac"].get(u) for u in flac_ids] != [hyps["eval wav"][u] for u, _w, _ws in corpus[:CLI_FLAC_UTTS]]:
        raise RuntimeError("eval: the FLAC corpus's transcripts differ from the WAV corpus's")
    if ev_cn["utts"] != CLI_CONSENSUS_UTTS or not np.isfinite(ev_cn["wer"]):
        raise RuntimeError(f"eval --consensus: {ev_cn}")
    shutil.rmtree(work, ignore_errors=True)
    sc, al = record("score", "score"), record("align", "align")
    line = (f"GMM CLI twins on real corpora: {len(corpus)} held-out utterances written as WAV in "
            f"{files['wav_s']:.1f} s, {CLI_FLAC_UTTS} as FLAC in LibriSpeech layout in {files['flac_s']:.1f} s; the "
            f"native FLAC decoder loaded ({os.path.relpath(lib._name, ROOT)}); six runs at once, exited 0 in "
            f"{all_s:.1f} s: features (FLAC) {feat['frames']} frames in {feat['wall_sec']:.3f} s, parity max |err| "
            f"{parity['max_abs_err']:.3g}, the ark read back; score (WAV, phase 16's monophone model "
            f"{gmm.n_states} x {gmm.n_components}) {sc['frames']} frames at {sc['frames_per_sec']:.0f} frames/s, "
            f"{fb.utt_ids[i]} within {score_err:.3g} of plain (atol {K1_ATOL} rtol {K1_RTOL}); align {al['utts']} "
            f"utterances in {al['wall_sec']:.3f} s, a batch of {fb.size} bitwise the plain path's pdfs; eval --bundle: "
            f"WAV WER {ev_wav['wer']:.4f} over {ev_wav['utts']} (limit {MAX_WER}; phase 6's in-memory float32 "
            f"plain path {plain_wer:.4f}), {ev_wav['utts_per_sec_per_chip']:.1f} utt/s, RTF {ev_wav['rtf']:.6f}; FLAC "
            f"WER {ev_flac['wer']:.4f}, its {CLI_FLAC_UTTS} transcripts = the WAV run's; --consensus on "
            f"{CLI_CONSENSUS_UTTS} utterances of the small lexicon (random GMM) WER {ev_cn['wer']:.4f} in "
            f"{ev_cn['wall_sec']:.2f} s; launches of "
            f"features + score + align + eval on {CLI_COUNT_UTTS} utterances in this process {launches}")
    return line, launches


def streaming_phases(dev: torch.device, gmm, fcfg, dcfg, graph, corpus, bcfg) -> dict:
    """Phases 23-26: the streaming front end, the online decoder on K2's
    chunk arm, the streaming LstmAm on K4's carry arm, pitch and the CLI
    twins. Returns the launch counts of their paths and the K2 chunk and K4
    carry sub-entries of the kernels line."""
    import contextlib
    import dataclasses
    import io
    import shutil

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import fast_lstm, gmm_cuda, lstm_cuda
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.params import init_
    from mogasr_torch.cli import stream as cli_stream
    from mogasr_torch.config import BatchConfig
    from mogasr_torch.decoder import online, viterbi_cuda
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.frontend.pitch import extract_pitch

    torch.set_grad_enabled(False)
    sr = fcfg.sample_rate
    audio_s = sum(len(w) for _u, w, _ws in corpus) / sr

    def zero_counts():
        torch.cuda.synchronize()
        gmm_cuda.LAUNCHES = gmm_cuda.WIDE_LAUNCHES = gmm_cuda.INT8_LAUNCHES = 0
        viterbi_cuda.LAUNCHES = viterbi_cuda.CHUNK_LAUNCHES = viterbi_cuda.BACKTRACE_LAUNCHES = 0
        lstm_cuda.LAUNCHES = lstm_cuda.CARRY_LAUNCHES = 0

    def counts():
        torch.cuda.synchronize()
        return {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES,
                "viterbi_chunk": viterbi_cuda.CHUNK_LAUNCHES, "viterbi_backtrace": viterbi_cuda.BACKTRACE_LAUNCHES,
                "lstm_scan": lstm_cuda.LAUNCHES, "lstm_scan_carry": lstm_cuda.CARRY_LAUNCHES}

    def by_id(batches):
        return {u: fb.feats[i, : int(fb.n_frames[i])] for fb in batches for i, u in enumerate(fb.utt_ids)}

    # ---- phase 23: the streaming front end at full width, then K1 + K2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_batches = pipe.featurize_streaming(corpus, fcfg, bcfg, dev, chunk_samples=int(sr * STREAM_CHUNK_MS / 1e3))
    torch.cuda.synchronize()
    st_s = time.perf_counter() - t0
    st_feats, off_feats = by_id(st_batches), by_id(pipe.featurize(corpus, fcfg, bcfg, dev))
    if set(st_feats) != set(off_feats) or len(st_feats) != len(corpus):
        raise RuntimeError(f"featurize_streaming kept {len(st_feats)} utterances, featurize {len(off_feats)}")
    st_err = 0.0
    for u, f in off_feats.items():
        if st_feats[u].shape != f.shape:
            raise RuntimeError(f"streaming features of {u}: {tuple(st_feats[u].shape)} vs offline {tuple(f.shape)}")
        st_err = max(st_err, float((st_feats[u] - f).abs().max()))
    if st_err > STREAM_FEATS_ATOL:
        raise RuntimeError(f"streaming features off the offline front end by {st_err} (limit {STREAM_FEATS_ATOL})")
    p_bf16 = gmm_cuda.kernel_params(gmm, "bfloat16", mode="max")
    graphs_d = pipe.decode_graphs(graph, bcfg.batch_size, dev)

    def decode(batches):
        hyps = {}
        for fb in batches:
            ll = pipe.score_batch(fb.feats, gmm, compute_dtype="bfloat16", mode="max", params=p_bf16)
            for u, toks in zip(fb.utt_ids, pipe.decode_batch(fb, ll, graph, dcfg, graphs=graphs_d)):
                hyps[u] = [w.lower() for w in toks]
        return hyps

    zero_counts()
    t0 = time.perf_counter()
    st_hyps = decode(st_batches)
    st_launches = counts()
    st_dec_s = time.perf_counter() - t0
    if min(st_launches["gmm_score"], st_launches["viterbi"]) == 0:
        raise RuntimeError(f"the streaming path did not go through K1 and K2: {st_launches}")
    off_hyps = decode(pipe.featurize(corpus, fcfg, bcfg, dev))
    refs = [[w.lower() for w in words] for _u, _w, words in corpus]
    st_wer = corpus_wer(refs, [st_hyps[u] for u, _w, _ws in corpus])[0]
    off_wer = corpus_wer(refs, [off_hyps[u] for u, _w, _ws in corpus])[0]
    n_diff = sum(st_hyps[u] != off_hyps[u] for u, _w, _ws in corpus)
    if st_wer > MAX_WER:
        raise RuntimeError(f"streaming WER {st_wer:.4f} > {MAX_WER}")
    phase(23, f"streaming front end ({STREAM_CHUNK_MS:g} ms chunks) on the {len(corpus)} held-out utterances: "
              f"{st_s:.2f} s, RTF {st_s / audio_s:.6f} ({audio_s:.1f} s of audio); features within {st_err:.3g} of "
              f"the offline front end (limit {STREAM_FEATS_ATOL}); decoded (K1 bf16/max, K2) in {st_dec_s:.3f} s: WER "
              f"{st_wer:.4f} (limit {MAX_WER}; the offline features' {off_wer:.4f}), {n_diff} transcripts differ "
              f"from the offline pass'; launches {st_launches}")
    del st_batches, st_feats, off_feats

    # ---- phase 24: the online decoder on K2's chunk arm, at full width
    obcfg = BatchConfig(batch_size=ONLINE_BATCH, bucket_boundaries=(600,))
    ofbs = pipe.featurize(corpus, fcfg, obcfg, dev)
    p32 = gmm_cuda.kernel_params(gmm, "float32")
    graphs_o = pipe.decode_graphs(graph, ONLINE_BATCH, dev)[1]
    J = graph.n_states
    scale = dcfg.acoustic_scale
    on_launches = dict.fromkeys(("gmm_score", "viterbi", "viterbi_chunk", "viterbi_backtrace"), 0)
    proc_ms, part_ms, buf_bytes, n_frames_all, fin_ms = [], [], 0, 0, []
    check, chunk_err = {}, 0.0
    for bi, fb in enumerate(ofbs):
        zero_counts()
        ll = pipe.score_batch(fb.feats, gmm, compute_dtype="float32", mode="sum", params=p32)
        dec = online.OnlineDecoder(graphs_o, acoustic_scale=scale)
        nf = fb.n_frames.cpu().numpy()
        T = ll.shape[1]
        for off in range(0, T, ONLINE_TC):
            tc = min(ONLINE_TC, T - off)
            nv = np.clip(nf - off, 0, tc).astype(np.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.process(ll[:, off:off + tc], nv)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec.partial()
            torch.cuda.synchronize()
            proc_ms.append(1e3 * (t1 - t0))
            part_ms.append(1e3 * (time.perf_counter() - t1))
        t0 = time.perf_counter()
        path, entered, score = dec.finalize()
        torch.cuda.synchronize()
        fin_ms.append(1e3 * (time.perf_counter() - t0))
        c = counts()
        for k in on_launches:
            on_launches[k] += c[k]
        if c["viterbi"] or not (c["gmm_score"] and c["viterbi_chunk"] and c["viterbi_backtrace"]):
            raise RuntimeError(f"the online path's launches: {c} (K1 and K2's chunk arm only)")
        buf_bytes = max(buf_bytes, dec.buffer_bytes)
        n_frames_all += int(nf.sum())
        # the comparisons, not counted: offline K2 on the same scores
        want = viterbi_cuda.viterbi(ll, graphs_o, fb.n_frames, acoustic_scale=scale)
        live = fb.n_frames > 0
        if not (torch.equal(path, want.path) and torch.equal(entered, want.entered)
                and torch.equal(score[live], want.score[live])):
            raise RuntimeError(f"online finalize differs from offline K2 on batch {bi}")
        if bi == len(ofbs) - 1:  # the widest batch: the chunk arm against the plain chunk step, then timed
            for beam in (0.0, K2_BEAM):
                d = torch.full((ONLINE_BATCH, J), online.NEG_INF, device=dev)
                s = torch.zeros(ONLINE_BATCH, dtype=torch.bool, device=dev)
                pd, ps = d.clone(), s.clone()
                bp, xa = viterbi_cuda.code_buffers(ONLINE_BATCH, J, ONLINE_CHECK_CHUNKS * ONLINE_TC, dev)
                for ci in range(ONLINE_CHECK_CHUNKS):
                    off = ci * ONLINE_TC
                    nv = torch.as_tensor(np.clip(nf - off, 0, ONLINE_TC).astype(np.int32), device=dev)
                    chunk = ll[:, off:off + ONLINE_TC]
                    viterbi_cuda.chunk_step(d, s, chunk, nv, graphs_o, scale, beam, bp, xa, off)
                    pd, ps, pbp, pxa = online.chunk_step(pd, ps, chunk, nv, graphs_o, scale, beam)
                    codes = viterbi_cuda.unpack_codes(bp, slice(off, off + ONLINE_TC), J)
                    enter = codes == 2
                    xs = xa[:, off:off + ONLINE_TC].t()[:, :, None].expand(ONLINE_TC, ONLINE_BATCH, J)
                    chunk_err = max(chunk_err, float((d - pd).abs().max()))
                    if not (torch.equal(d, pd) and torch.equal(s, ps) and torch.equal(codes, pbp)
                            and torch.equal(xs[enter], pxa[:, :, None].expand_as(xs)[enter])):
                        raise RuntimeError(f"K2's chunk arm (beam {beam}) differs from the plain step at chunk {ci}")
                check[beam] = int(enter.sum())
            nv_full = torch.as_tensor(np.clip(nf, 0, ONLINE_TC).astype(np.int32), device=dev)
            chunk0 = ll[:, :ONLINE_TC].contiguous()
            dt_, st_ = torch.full((ONLINE_BATCH, J), online.NEG_INF, device=dev), torch.ones(
                ONLINE_BATCH, dtype=torch.bool, device=dev)
            dt_.copy_(dec.delta)
            bpt, xat = viterbi_cuda.code_buffers(ONLINE_BATCH, J, ONLINE_TC, dev)
            chunk_ms, _ = timed(lambda: viterbi_cuda.chunk_step(dt_, st_, chunk0, nv_full, graphs_o, scale, 0.0, bpt,
                                                                xat, 0), 20)
            chunk_plain_ms, _ = timed(lambda: online.chunk_step(dt_.clone(), st_.clone(), chunk0, nv_full, graphs_o,
                                                                scale, 0.0), 2)
            nft = torch.as_tensor(dec.n_frames.astype(np.int32), device=dev)
            bt_ms, _ = timed(lambda: viterbi_cuda.backtrace(dec.delta, None, nft, dec._bp, dec._xa, dec.frames), 20)
            chunk_bound = k2_chunk_bound(graphs_o, nv_full, st_, ONLINE_TC)
            bt_bound = bound(ONLINE_BATCH * J * 4 + int(nft.sum()) * (8 + 4 + 5) + ONLINE_BATCH * 8,
                             ONLINE_BATCH * J, "float32")
            chunk_frames = int(nv_full.sum())
        del ll, dec
    proc_ms, part_ms = np.asarray(proc_ms), np.asarray(part_ms)
    phase(24, f"online decode of the {len(corpus)} held-out utterances ({len(ofbs)} batches of {ONLINE_BATCH} "
              f"streams, K1 float32/sum scores, {ONLINE_TC}-frame chunks, a partial after each): finalize bitwise "
              f"offline K2 (path, entered, score) on every utterance; K2's chunk arm bitwise the plain chunk step on "
              f"the first {ONLINE_CHECK_CHUNKS} chunks of the widest batch (delta, started, codes, the exit argmax "
              f"of {check[0.0]} enter codes), also with beam {K2_BEAM:g} ({check[K2_BEAM]}); per chunk of "
              f"{ONLINE_BATCH} streams: process median {np.median(proc_ms):.3f} ms (p90 "
              f"{np.percentile(proc_ms, 90):.3f}), partial median {np.median(part_ms):.3f} ms (p90 "
              f"{np.percentile(part_ms, 90):.3f}), finalize {np.median(fin_ms):.3f} ms, host clock; "
              f"{n_frames_all} frames decoded; the chunk arm on the device {chunk_ms:.4f} ms a chunk of {chunk_frames} "
              f"frames (plain {chunk_plain_ms:.3f} ms, bound {chunk_bound[0]:.4f} ms by {chunk_bound[1]}), the "
              f"backtrace alone {bt_ms:.4f} ms (bound {bt_bound[0]:.4f} ms); codes buffer {buf_bytes} bytes a batch "
              f"(uint8 backpointers would be {ONLINE_BATCH * 600 * J} bytes); launches {on_launches}")
    k2_chunk = {"launches": on_launches["viterbi_chunk"] + on_launches["viterbi_backtrace"],
                "launches_by_path": {"online": {"chunk": on_launches["viterbi_chunk"],
                                                "backtrace": on_launches["viterbi_backtrace"]}},
                "max_abs_err": chunk_err, "ms": chunk_ms, "plain_ms": chunk_plain_ms, "bound_ms": chunk_bound[0],
                "bound_by": chunk_bound[1], "library_ms": None, "shape": [ONLINE_BATCH, ONLINE_TC, J],
                "process_ms_host": float(np.median(proc_ms)), "partial_ms_host": float(np.median(part_ms)),
                "codes_buffer_bytes": buf_bytes,
                "backtrace": {"ms": bt_ms, "bound_ms": bt_bound[0], "bound_by": bt_bound[1]}}

    # ---- phase 25: K4's carry arm, and the streaming LstmAm
    B4, T4, H = 64, 600, STREAM_NN_HIDDEN
    rng = np.random.default_rng(25)
    xg = torch.as_tensor(rng.standard_normal((B4, T4, 4 * H)).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32), device=dev)
    nf4 = torch.as_tensor(np.r_[T4, 1, 0, 0, rng.integers(1, T4 + 1, B4 - 4)].astype(np.int32), device=dev)
    h0, c0 = (torch.as_tensor(rng.standard_normal((B4, H)).astype(np.float32), device=dev) for _ in range(2))
    zero = nf4 == 0
    carry_err = {}
    for dt in ("float32", "bfloat16"):
        got, (h, c) = lstm_cuda.lstm_layer(xg, w, nf4, dt, h0=h0, c0=c0, return_carry=True)
        want, (hp, cp) = fast_lstm.lstm_layer(xg, w, nf4, dt, h0=h0, c0=c0, return_carry=True)
        torch.cuda.synchronize()
        carry_err[dt] = max(float((a - b).abs().max()) for a, b in ((got, want), (h, hp), (c, cp)))
        if carry_err[dt] > K4_ATOL[dt]:
            raise RuntimeError(f"K4's carry arm ({dt}) off the plain recurrence by {carry_err[dt]}")
        if not (torch.equal(h[zero], h0[zero]) and torch.equal(c[zero], c0[zero])):
            raise RuntimeError(f"K4's carry arm ({dt}): a row with no frame changed its carries")
    ragged_ms, _ = timed(lambda: lstm_cuda.lstm_layer(xg, w, nf4, "float32", h0=h0, c0=c0, return_carry=True), 5)
    del xg, got, want
    # the streaming LstmAm 81 x 512 x 2 on the widest online batch's first rows, chunked, against offline
    model = init_(tn.LstmAmStream(STREAM_NN_PDFS, fcfg.feat_dim, hidden=H, layers=2),
                  torch.Generator().manual_seed(0)).to(dev)
    fbw = ofbs[-1]
    feats, nfs = fbw.feats[:B4], fbw.n_frames[:B4]
    offline = tn.LstmAm.forward(model, feats, nfs)
    zero_counts()
    carries = tn.lstm_stream_init(model, feats.shape[0], dev)
    outs = []
    nfs_np = nfs.cpu().numpy()
    for off in range(0, feats.shape[1], ONLINE_TC):
        nv = torch.as_tensor(np.clip(nfs_np - off, 0, ONLINE_TC).astype(np.int32), device=dev)
        y, carries = model(feats[:, off:off + ONLINE_TC], carries, n_valid=nv)
        outs.append(y)
    nn_launches = counts()
    if nn_launches["lstm_scan_carry"] == 0 or nn_launches["lstm_scan"] != nn_launches["lstm_scan_carry"]:
        raise RuntimeError(f"the streaming LstmAm's launches: {nn_launches} (K4's carry arm only)")
    vmask = tn.valid_mask(nfs, feats.shape[1], dev)
    nn_err = float((torch.cat(outs, 1)[vmask] - offline[vmask]).abs().max())
    if nn_err > STREAM_NN_ATOL:
        raise RuntimeError(f"the streamed LstmAm is {nn_err} off the offline LstmAm (limit {STREAM_NN_ATOL})")
    # one chunk of layer 1 from carries: K4's carry arm, plain, and cuDNN nn.LSTM with (h0, c0)
    cell = model.cells[1]
    x_c = torch.as_tensor(rng.standard_normal((B4, ONLINE_TC, H)).astype(np.float32), device=dev)
    xg_c = cell.input_gates(x_c, "float32")
    nv_c = torch.full((B4,), ONLINE_TC, dtype=torch.int32, device=dev)
    k4c_ms, (y_k, _) = timed(lambda: lstm_cuda.lstm_layer(xg_c, cell.w_rec, nv_c, "float32", h0=h0, c0=c0,
                                                          return_carry=True), 20)
    k4c_plain_ms, _ = timed(lambda: fast_lstm.lstm_layer(xg_c, cell.w_rec, nv_c, "float32", h0=h0, c0=c0,
                                                         return_carry=True), 3)
    gemm_k4c_ms, _ = timed(lambda: lstm_cuda.lstm_layer(cell.input_gates(x_c, "float32"), cell.w_rec, nv_c,
                                                        "float32", h0=h0, c0=c0, return_carry=True), 20)
    cudnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    cudnn.weight_ih_l0.copy_(cell.w_in.T)
    cudnn.weight_hh_l0.copy_(cell.w_rec.T)
    cudnn.bias_ih_l0.zero_()
    cudnn.bias_hh_l0.copy_(cell.bias)
    lib_c_ms, (y_lib, _) = timed(lambda: cudnn(x_c, (h0[None], c0[None])), 20)
    lib_c_err = float((y_lib - y_k).abs().max())
    frames_c = B4 * ONLINE_TC
    k4c_bound = bound(frames_c * 4 * H * 4 + frames_c * H * 4 + 4 * B4 * H * 4 + H * 4 * H * 4,
                      frames_c * H * (2 * 4 * H + K4_GATE_OPS), "float32")
    phase(25, f"K4's carry arm on B={B4} T={T4} H={H} (n_frames {nf4.tolist()[:5]}..., random carries) within "
              f"K4's tolerance of plain: max |err| float32 {carry_err['float32']:.3g}, bfloat16 "
              f"{carry_err['bfloat16']:.3g} (atol {K4_ATOL['float32']}, {K4_ATOL['bfloat16']}); the carries of the "
              f"{int(zero.sum())} rows without frames bitwise unchanged; float32 {ragged_ms:.3f} ms; LstmAm "
              f"{STREAM_NN_PDFS} x {H} x 2 streamed in {ONLINE_TC}-frame chunks on {feats.shape[0]} rows of the widest batch: "
              f"max |err| against the offline LstmAm on the card {nn_err:.3g} (limit {STREAM_NN_ATOL}; "
              f"{'bitwise' if nn_err == 0 else 'not bitwise'}), launches {nn_launches}; one chunk of layer 1 "
              f"({B4} x {ONLINE_TC}) from carries: K4 {k4c_ms:.4f} ms (plain {k4c_plain_ms:.3f} ms, bound "
              f"{k4c_bound[0]:.4f} ms by {k4c_bound[1]}), input GEMM + K4 {gemm_k4c_ms:.4f} ms vs cuDNN nn.LSTM with "
              f"(h0, c0) {lib_c_ms:.4f} ms (max |diff| {lib_c_err:.3g})")
    k4_carry = {"launches": nn_launches["lstm_scan_carry"], "launches_by_path": {"stream_nn": nn_launches["lstm_scan"]},
                "max_abs_err": carry_err["float32"], "bfloat16_max_abs_err": carry_err["bfloat16"],
                "ms": k4c_ms, "plain_ms": k4c_plain_ms, "bound_ms": k4c_bound[0], "bound_by": k4c_bound[1],
                "library_ms": lib_c_ms, "library": "torch.nn.LSTM (cuDNN) with (h0, c0), the whole layer",
                "ms_with_input_gemm": gemm_k4c_ms, "shape": [B4, ONLINE_TC, H], "ragged_600_ms": ragged_ms,
                "stream_vs_offline_max_abs_err": nn_err}
    del model, offline, outs, ofbs

    # ---- phase 26: pitch, and the CLI twins
    pitch_utts = corpus[:PITCH_UTTS]
    pcfg = dataclasses.replace(fcfg, add_pitch=True)
    pb = BatchConfig(batch_size=PITCH_UTTS, bucket_boundaries=(600,))
    card = pipe.featurize(pitch_utts, pcfg, pb, dev)
    cpu = pipe.featurize(pitch_utts, pcfg, pb, torch.device("cpu"))
    D = fcfg.feat_dim
    pitch_err = max(float((a.feats[..., D:].cpu() - b.feats[..., D:]).abs().max()) for a, b in zip(card, cpu))
    spec_err = max(float((a.feats[..., :D].cpu() - b.feats[..., :D]).abs().max()) for a, b in zip(card, cpu))
    if pitch_err > PITCH_ATOL or spec_err > FRONTEND_ATOL:
        raise RuntimeError(f"add_pitch features on the card off the CPU's: pitch {pitch_err}, spectral {spec_err}")
    waves = np.zeros((len(pitch_utts), max(len(w) for _u, w, _ws in pitch_utts)), np.float32)
    for i, (_u, wv, _ws) in enumerate(pitch_utts):
        waves[i, :len(wv)] = wv
    waves_t = torch.as_tensor(waves, device=dev)
    ns_t = torch.as_tensor([len(wv) for _u, wv, _ws in pitch_utts], device=dev)
    pitch_ms, (_pf, pnf) = timed(lambda: extract_pitch(waves_t, ns_t), 3)
    pitch_T = int(fcfg.num_frames(waves.shape[1]))
    work = os.path.join(ROOT, "build", "chip_smoke_stream_cli")
    shutil.rmtree(work, ignore_errors=True)
    ctm = os.path.join(work, "out.ctm")
    runs = {
        "stream": ("stream", ["--synthetic-demo"]),
        "stream endpoint": ("stream", ["--synthetic-demo", "--endpoint"]),
        "transcribe": ("transcribe", ["--synthetic-demo", "--nbest", "2", "--ctm", ctm]),
        "eval streaming": ("eval", ["--synthetic-v2", str(STREAM_CLI_EVAL_UTTS), "--bundle", BUNDLE, "--streaming"]),
    }
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = {}
    t0 = time.perf_counter()
    for name, (module, args) in runs.items():
        run_dir = os.path.join(work, name.replace(" ", "_"))
        cmd = [sys.executable, "-m", f"mogasr_torch.cli.{module}", *args, "--run-dir", run_dir, "--device", str(dev)]
        procs[name] = (run_dir, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    try:
        # meanwhile, in this process: the stream twin's launches
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            cli_stream.main(["--synthetic-demo", "--device", str(dev), "--run-dir", os.path.join(work, "counted")])
        cli_launches = counts()
        if cli_launches["viterbi"] or not (cli_launches["gmm_score"] and cli_launches["viterbi_chunk"]
                                           and cli_launches["viterbi_backtrace"]):
            raise RuntimeError(f"the stream twin's launches: {cli_launches} (K1 and K2's chunk arm only)")
        outs = {}
        for name, (run_dir, proc) in procs.items():
            out, err = proc.communicate(timeout=max(CLI_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if proc.returncode != 0:
                raise RuntimeError(f"the CLI twin ({name}) failed ({proc.returncode}): {err[-2000:]}")
            outs[name] = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        all_s = time.perf_counter() - t0
    finally:
        for _run_dir, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    counted = [json.loads(line) for line in cli_out.getvalue().splitlines() if line.startswith("{")]
    checks = []
    for name in ("stream", "stream endpoint"):
        ev = [e for e in outs[name] if "partial" in e or "final" in e]
        if len(ev) < 3 or "final" not in ev[-1] or not all("partial" in e for e in ev[:-1]):
            raise RuntimeError(f"the stream twin ({name}) printed {ev}")
        if name == "stream endpoint" and "endpoint" not in ev[-1]:
            raise RuntimeError(f"the stream twin with --endpoint did not endpoint: {ev[-1]}")
        checks.append(f"{name}: {len(ev) - 1} partials, final {ev[-1]['final']}, RTF {ev[-1]['rtf']}"
                      + (f", endpoint {ev[-1]['endpoint']} at {ev[-1]['endpoint_t_s']} s" if "endpoint" in ev[-1]
                         else ""))
    if [e for e in counted if "final" in e][-1]["final"] != [e for e in outs["stream"] if "final" in e][-1]["final"]:
        raise RuntimeError("the stream twin in this process and in its own disagree")
    segs = [r for r in outs["transcribe"] if "words" in r]
    with open(ctm) as f:
        ctm_rows = [line.split() for line in f]
    if len(segs) != 4 or any(len(r["nbest"]) != 2 or len(r["confidences"]) != len(r["words"]) for r in segs) or \
            len(ctm_rows) != sum(len(r["words"]) for r in segs):
        raise RuntimeError(f"the transcribe twin printed {segs}, {len(ctm_rows)} CTM rows")
    checks.append(f"transcribe: {len(segs)} segments, {len(ctm_rows)} CTM rows, words "
                  + " | ".join(" ".join(r["words"]) for r in segs))
    with open(os.path.join(work, "eval_streaming", "metrics.jsonl")) as f:
        ev = [r for r in map(json.loads, f) if r["stage"] == "eval"]
    if len(ev) != 1 or ev[0]["utts"] != STREAM_CLI_EVAL_UTTS or not np.isfinite(ev[0]["wer"]):
        raise RuntimeError(f"eval --streaming: {ev}")
    checks.append(f"eval --bundle --streaming on {ev[0]['utts']} v2 utterances: WER {ev[0]['wer']:.4f}, "
                  f"{ev[0]['utts_per_sec_per_chip']:.1f} utt/s, RTF {ev[0]['rtf']:.6f}")
    shutil.rmtree(work, ignore_errors=True)
    phase(26, f"featurize with add_pitch on {PITCH_UTTS} utterances on the card against the CPU: pitch columns max "
              f"|err| {pitch_err:.3g} (limit {PITCH_ATOL}), spectral {spec_err:.3g}; extract_pitch of the "
              f"{PITCH_UTTS} x {pitch_T} frames {pitch_ms:.1f} ms on the card ({pitch_ms / pitch_T:.3f} ms a frame of "
              f"its lag Viterbi loop and backtrace, plain PyTorch ops); CLI twins, four runs at once, exited 0 in "
              f"{all_s:.1f} s: " + "; ".join(checks) + f"; the stream twin in this process launched {cli_launches}")
    return {"streaming": st_launches, "online": on_launches, "stream_cli": cli_launches, "k2_chunk": k2_chunk,
            "k4_carry": k4_carry}


def zero_launches() -> None:
    from mogasr_torch.am import gmm_cuda, lstm_cuda
    from mogasr_torch.decoder import fb_cuda, viterbi_cuda

    torch.cuda.synchronize()
    gmm_cuda.LAUNCHES = gmm_cuda.WIDE_LAUNCHES = gmm_cuda.INT8_LAUNCHES = viterbi_cuda.LAUNCHES = 0
    fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = lstm_cuda.LAUNCHES = 0


def launch_counts() -> dict:
    from mogasr_torch.am import gmm_cuda, lstm_cuda
    from mogasr_torch.decoder import fb_cuda, viterbi_cuda

    torch.cuda.synchronize()
    return dict(zip(KERNEL_COUNTERS, (gmm_cuda.LAUNCHES, gmm_cuda.WIDE_LAUNCHES, gmm_cuda.INT8_LAUNCHES,
                                      viterbi_cuda.LAUNCHES, fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES,
                                      fb_cuda.COMBINE_LAUNCHES, lstm_cuda.LAUNCHES)))


def require_k1_k2_only(name: str, counts: dict) -> None:
    if min(counts["gmm_score"], counts["viterbi"]) == 0 or \
            any(v for k, v in counts.items() if k not in ("gmm_score", "viterbi")):
        raise RuntimeError(f"{name}: launches {counts} (K1 float32/sum and K2 only)")


def peak_gib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def adaptation_phases(dev, gmm, fcfg, dcfg, graph, tied, topo, held_out, bcfg, train_corpus, train_fbs,
                      train_speakers, trained, gcfg, entry, plain_wer) -> dict:
    """Phases 27 (two-pass fMLLR, MLLR and VTLN decodes of the held-out
    corpus, kernel path against the plain path, and the corrupted-speaker
    check), 28 (SAT, STC and LDA+MLLT on the training corpus) and 29
    (i-vectors and diarization). Returns the launches per path."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import ivector as iv
    from mogasr_torch.cli import diarize as cli_diarize
    from mogasr_torch.cli.diarize import build_session
    from mogasr_torch.config import BatchConfig, FrontendConfig, GmmConfig, TrainConfig
    from mogasr_torch.diarize import diarize_wave, train_diarizer
    from mogasr_torch.eval.diarization import der
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.hmm import triphone as tri

    lex = topo.lexicon
    corpus = [(u.utt_id, u.wave, u.words) for u in held_out]
    speaker = {u.utt_id: u.speaker for u in held_out}
    refs = {u.utt_id: [w.lower() for w in u.words] for u in held_out}
    utts_of = {}
    for u in held_out:
        utts_of.setdefault(u.speaker, []).append(u.utt_id)
    align_fn = lambda p: tri.align_graph_cd(tied, p)  # noqa: E731
    fbs = pipe.featurize(corpus, fcfg, bcfg, dev)
    paths = {}

    def wer_of(hyps, ids=None):
        ids = list(refs) if ids is None else ids
        return corpus_wer([refs[u] for u in ids], [[w.lower() for w in hyps[u]] for u in ids])[0]

    def measured(name, fn):
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts(), peak_gib()

    # ---- phase 27: two-pass adaptation on the headline bundle. The kernel
    # path decodes every held-out utterance (the WER gate); the plain path,
    # the slow one, is held to the kernel path on the first held-out batch's
    # utterances of ADAPT_PLAIN_SPEAKERS speakers, both paths estimating their
    # transforms from those alone (a pass's host solves go by speakers)
    plain_spk = set(sorted(utts_of)[:ADAPT_PLAIN_SPEAKERS])
    fb0 = fbs[0]
    rows = [b for b, u in enumerate(fb0.utt_ids) if speaker[u] in plain_spk]
    idx = torch.as_tensor(rows, device=fb0.feats.device)
    sub_fbs = [pipe.FeatBatch([fb0.utt_ids[b] for b in rows], fb0.feats[idx], fb0.n_frames[idx],
                              [fb0.words[b] for b in rows])]
    sub_ids = sub_fbs[0].utt_ids
    sub_corpus = [c for c in corpus if c[0] in set(sub_ids)]
    two_pass = {
        "fmllr": lambda uk, rep, b, _c: pipe.decode_with_fmllr(b, gmm, lex, topo, dcfg, speaker.__getitem__,
                                                               graph=graph, align_fn=align_fn, use_kernels=uk,
                                                               report=rep),
        "mllr": lambda uk, rep, b, _c: pipe.decode_with_mllr(b, gmm, lex, topo, dcfg, speaker.__getitem__,
                                                             graph=graph, align_fn=align_fn, use_kernels=uk,
                                                             report=rep),
        "vtln": lambda uk, rep, _b, c: pipe.decode_with_vtln(c, gmm, lex, topo, fcfg, bcfg, dcfg,
                                                             speaker_of=speaker.__getitem__, graph=graph,
                                                             align_fn=align_fn, use_kernels=uk, report=rep),
    }
    lines = []
    for name, fn in two_pass.items():
        runs = {}
        for key, uk, b, c in (("all", True, fbs, corpus), ("kernel", True, sub_fbs, sub_corpus),
                              ("plain", False, sub_fbs, sub_corpus)):
            rep = {}
            (hyps, per_spk), secs, counts, peak = measured(name, lambda: fn(uk, rep, b, c))
            runs[key] = dict(hyps=hyps, per_spk=per_spk, rep=rep, s=secs, launches=counts, peak=peak)
        full, k, p = runs["all"], runs["kernel"], runs["plain"]
        for key in ("all", "kernel"):
            require_k1_k2_only(f"two-pass {name} (kernel path)", runs[key]["launches"])
        if any(p["launches"].values()):
            raise RuntimeError(f"two-pass {name} with use_kernels=False launched {p['launches']}")
        paths[f"adapt_{name}"] = full["launches"]
        wer_k, wer_p = wer_of(full["hyps"]), wer_of(p["hyps"], sub_ids)
        same = sum(k["hyps"][u] == p["hyps"][u] for u in sub_ids) / len(sub_ids)
        if len(full["hyps"]) != len(refs) or len(p["hyps"]) != len(sub_ids) or wer_k > MAX_WER or \
                same < MIN_AGREEMENT:
            raise RuntimeError(f"two-pass {name}: {len(full['hyps'])} utterances, WER {wer_k:.4f} (limit {MAX_WER}), "
                               f"transcripts agree with the plain path on {same:.4f} of {len(sub_ids)}")
        if name == "vtln":
            if k["per_spk"] != p["per_spk"]:
                raise RuntimeError(f"VTLN warps differ: kernel {k['per_spk']} plain {p['per_spk']}")
            margins = {spk: sorted(ll.values())[-1] - sorted(ll.values())[-2]
                       for spk, ll in full["rep"]["loglik"].items()}
            detail = (f"warps {dict(sorted(full['per_spk'].items()))}; on those {len(sub_ids)} utterances "
                      f"warps {dict(sorted(k['per_spk'].items()))} equal on both paths; each speaker's margin "
                      f"best - second-best aligned loglik (nats over its frames, all utterances): "
                      + ", ".join(f"{spk} {m:.1f}" for spk, m in sorted(margins.items())))
        else:
            same_spk = [spk for spk in k["per_spk"] if all(
                np.array_equal(k["rep"]["labels1"][u], p["rep"]["labels1"][u]) for u in utts_of[spk]
                if u in k["rep"]["labels1"])]
            dw = max((float(np.abs(k["per_spk"][spk] - p["per_spk"][spk]).max()) for spk in same_spk), default=0.0)
            if not same_spk or dw > ADAPT_W_ATOL:
                raise RuntimeError(f"two-pass {name}: {len(same_spk)} speakers with identical pass-1 labels, "
                                   f"max |dW| {dw:.3g} (limit {ADAPT_W_ATOL})")
            detail = (f"{len(full['per_spk'])} speakers' transforms; on those {len(sub_ids)} utterances "
                      f"{len(k['per_spk'])}, {len(same_spk)} with identical pass-1 labels on both paths: max |dW| "
                      f"{dw:.3g} (limit {ADAPT_W_ATOL})")
        sec = lambda r: ", ".join(f"{kk} {v:.2f}" for kk, v in r["rep"]["seconds"].items())  # noqa: E731
        lines.append(f"{name}: pass-2 WER {wer_k:.4f} (limit {MAX_WER}; phase 5 {BUNDLE_WER}, phase 6's float32 "
                     f"sum path {plain_wer:.4f}); kernel path {full['s']:.2f} s (s {sec(full)}), launches "
                     f"{full['launches']}, peak {full['peak']:.2f} GiB; on {len(sub_ids)} utterances of "
                     f"{ADAPT_PLAIN_SPEAKERS} speakers in the first batch the plain path's WER {wer_p:.4f} (kernel "
                     f"{wer_of(k['hyps'], sub_ids):.4f}), "
                     f"transcripts agree on {same:.4f}; {detail}; kernel path {k['s']:.2f} s, plain path "
                     f"{p['s']:.2f} s (s {sec(p)}), peak {p['peak']:.2f} GiB")
    # the reference's adaptation check on CORRUPT_SPEAKERS speakers
    D = fcfg.feat_dim
    bad = sorted(utts_of)[:CORRUPT_SPEAKERS]
    bad_ids = [u for spk in bad for u in utts_of[spk]]

    def corrupted(b_scale):
        rng = np.random.default_rng(9)
        rng.standard_normal(D)
        W_bad = np.concatenate([np.eye(D) * 0.8, b_scale * rng.standard_normal(D)[:, None]], axis=1)
        return [pipe._apply_fmllr_batch(fb, {spk: W_bad.astype(np.float32) for spk in bad}, speaker.__getitem__)
                for fb in fbs]

    def si_hyps(batches):
        return {uid: hyp for fb in batches
                for uid, hyp in zip(fb.utt_ids, pipe.decode_batch(fb, pipe.score_batch(fb.feats, gmm), graph, dcfg))}

    test_b_si_wer = wer_of(si_hyps(corrupted(TEST_B)), bad_ids)
    bad_fbs = corrupted(CORRUPT_B)
    si = si_hyps(bad_fbs)
    (ad, _W), ad_s, ad_counts, ad_peak = measured("fmllr", lambda: pipe.decode_with_fmllr(
        bad_fbs, gmm, lex, topo, dcfg, speaker.__getitem__, graph=graph, align_fn=align_fn))
    si_wer, ad_wer = wer_of(si, bad_ids), wer_of(ad, bad_ids)
    if not (si_wer > CORRUPT_MIN_SI_WER and ad_wer < CORRUPT_RATIO * si_wer):
        raise RuntimeError(f"fMLLR on {CORRUPT_SPEAKERS} corrupted speakers: adapted WER {ad_wer:.4f}, SI WER "
                           f"{si_wer:.4f} (SI must be > {CORRUPT_MIN_SI_WER}, adapted < {CORRUPT_RATIO} x SI)")
    phase(27, f"two-pass adaptation of the {len(refs)} held-out utterances by speaker ({len(utts_of)} speakers, "
          f"{len(fbs)} batches; K1 float32/sum, K2's word-loop arm for the decodes and its chain arm for the "
          f"hypothesis alignment; CD loop and align graphs): " + "; ".join(lines)
          + f"; the reference's check, {CORRUPT_SPEAKERS} speakers ({len(bad_ids)} utterances) corrupted by "
          f"A = 0.8 I, b = {CORRUPT_B} N(0, 1) (the test's b = {TEST_B} N(0, 1): SI WER {test_b_si_wer:.4f}; "
          f"uncorrupted SI {wer_of(si_hyps(fbs), bad_ids):.4f}): SI WER {si_wer:.4f} (> {CORRUPT_MIN_SI_WER}), fMLLR two-pass "
          f"{ad_wer:.4f} (< {CORRUPT_RATIO} x SI) in {ad_s:.2f} s, launches {ad_counts}, peak {ad_peak:.2f} GiB")

    # ---- phase 28: SAT, STC and LDA+MLLT on the training corpus
    tspk = train_speakers.__getitem__
    sat_runs = []
    for _ in range(2):
        (sat_gmm, sat_W, sat_hist), sat_s, sat_counts, sat_peak = measured("sat", lambda: pipe.train_sat(
            train_fbs, lex, topo, gcfg, trained, tspk, n_iters=SAT_ITERS, align_fn=align_fn))
        sat_runs.append((sat_gmm, sat_W, sat_hist, sat_s, sat_counts, sat_peak))
    (g1, W1, h1, s1, c1, pk1), (g2, W2, h2, s2, _c2, _pk2) = sat_runs
    require_k1_k2_only("SAT", c1)
    paths["sat"] = c1
    if not (np.isfinite(h1).all() and h1[-1] > h1[0]):
        raise RuntimeError(f"SAT history {h1} does not rise")
    if h1 != h2 or W1.keys() != W2.keys() or not all(np.array_equal(W1[k], W2[k]) for k in W1) or \
            not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise RuntimeError("SAT: two runs are not bitwise equal")
    eye = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
    dev_w = sorted(float(np.abs(W - eye).max()) for W in W1.values())
    base_eval = pipe.evaluate(fbs, trained, lex, topo, dcfg, graph=graph)["wer"]
    (stc_out, stc_s, stc_counts, stc_peak) = measured("stc", lambda: pipe.estimate_stc_batches(
        train_fbs, trained, lex, topo, align_fn=align_fn))
    A_stc, _vars_y, gmm_y, tf = stc_out
    require_k1_k2_only("STC", stc_counts)
    paths["stc"] = stc_counts
    stc_wer = pipe.evaluate(tf(fbs), gmm_y, lex, topo, dcfg, graph=graph)["wer"]
    if not (np.isfinite(A_stc).all() and stc_wer <= base_eval + STC_WER_GAP):
        raise RuntimeError(f"STC: WER {stc_wer:.4f} against {base_eval:.4f} (gap limit {STC_WER_GAP})")
    gmm_mono, topo_m = entry["mono_gmm"], entry["mono_topo"]
    gcfg_lda = GmmConfig(n_states=topo_m.n_pdfs, n_components=8, feat_dim=LDA_DIM, var_floor=0.01,
                         min_split_occ=40.0)
    (lda, lda_s, lda_counts, lda_peak) = measured("lda", lambda: pipe.train_lda_mllt(
        train_corpus, lex, topo_m, fcfg, BatchConfig(batch_size=TRAIN_BATCH, bucket_boundaries=TRAIN_BUCKETS),
        gcfg_lda, TrainConfig(num_em_iters=10), gmm_mono, context=LDA_CONTEXT, lda_dim=LDA_DIM))
    require_k1_k2_only("LDA+MLLT", lda_counts)
    paths["lda_mllt"] = lda_counts
    mono_wer = pipe.evaluate(fbs, gmm_mono, lex, topo_m, dcfg)["wer"]
    lda_wer = pipe.evaluate(lda.featurize(corpus, bcfg), lda.gmm, lex, lda.topo, dcfg)["wer"]
    if lda.transform.shape != (LDA_DIM, (2 * LDA_CONTEXT + 1) * fcfg.base_dim + 1) or \
            not lda_wer <= mono_wer + LDA_WER_GAP or not lda.history[-1] > lda.history[0]:
        raise RuntimeError(f"LDA+MLLT: transform {lda.transform.shape}, history {lda.history}, held-out WER "
                           f"{lda_wer:.4f} against the monophone's {mono_wer:.4f} (+{LDA_WER_GAP})")
    phase(28, f"training-side transforms on the training corpus of phase 8 ({len(train_fbs)} batches, "
          f"{len(set(train_speakers.values()))} speakers): SAT {SAT_ITERS} iterations from phase 8's model: "
          f"Jacobian-corrected loglik per frame {[round(h, 4) for h in h1]}, {len(W1)} transforms (max |W - I| min "
          f"{dev_w[0]:.3f}, median {dev_w[len(dev_w) // 2]:.3f}, max {dev_w[-1]:.3f}), run twice bitwise equal "
          f"(transforms, history, model), {s1:.2f} and {s2:.2f} s, launches {c1}, peak {pk1:.2f} GiB; STC from "
          f"phase 8's model: {stc_s:.2f} s, launches {stc_counts}, peak {stc_peak:.2f} GiB, held-out WER "
          f"{stc_wer:.4f} in its space (the model's {base_eval:.4f}); LDA+MLLT at context {LDA_CONTEXT}, "
          f"{LDA_DIM} dims, booted from phase 16's monophone model ({gmm_mono.n_states} x {gmm_mono.n_components}): "
          f"{lda_s:.2f} s, history {[round(h, 3) for h in lda.history]}, launches {lda_counts}, peak "
          f"{lda_peak:.2f} GiB; held-out WER {lda_wer:.4f} against the monophone's {mono_wer:.4f} (limit "
          f"+{LDA_WER_GAP})")

    # ---- phase 29: i-vectors and diarization
    fcfg_nc = dataclasses.replace(fcfg, cmvn="none")  # utterance CMVN strips the speaker cues
    tbcfg = BatchConfig(batch_size=TRAIN_BATCH, bucket_boundaries=TRAIN_BUCKETS)
    train_nc = pipe.featurize(train_corpus, fcfg_nc, tbcfg, dev)
    held_nc = pipe.featurize(corpus, fcfg_nc, bcfg, dev)
    (ext, ext_s, _c, ext_peak) = measured("ivector", lambda: iv.train_ivector_extractor(train_nc))
    t0 = time.perf_counter()
    train_vecs = iv.extract_ivectors_batches(train_nc, ext.ubm, ext.t_mat)
    by_utt = iv.extract_ivectors_batches(held_nc, ext.ubm, ext.t_mat)
    ext_x_s = time.perf_counter() - t0
    ids = list(by_utt)
    norm = iv.length_normalize(np.stack([by_utt[u] for u in ids]) - np.stack(list(train_vecs.values())).mean(0))
    sims = norm @ norm.T
    lab = np.array([speaker[u] for u in ids])
    same_mask = (lab[:, None] == lab[None, :]) & ~np.eye(len(ids), dtype=bool)
    same_cos, diff_cos = float(sims[same_mask].mean()), float(sims[lab[:, None] != lab[None, :]].mean())
    if not same_cos > diff_cos + IVEC_MARGIN:
        raise RuntimeError(f"i-vectors: same-speaker cosine {same_cos:.4f}, different {diff_cos:.4f} "
                           f"(margin {IVEC_MARGIN})")
    wave, drefs, dtrain = build_session(2, 10, seed=4)
    t0 = time.perf_counter()
    ubm, t_mat = train_diarizer(dtrain[:24], FrontendConfig(cmvn="none"), n_components=16, rank=8, ubm_iters=6,
                                tv_iters=6, device=dev)
    t1 = time.perf_counter()
    turns = diarize_wave(wave, FrontendConfig(cmvn="none"), ubm, t_mat, n_speakers=2)
    t2 = time.perf_counter()
    d2 = der(drefs, turns, collar_s=0.25)
    d1 = der(drefs, [(a, b, 0) for a, b, _l in turns], collar_s=0.25)
    if len({lab_ for _a, _b, lab_ in turns}) != 2 or not d2["der"] < DER_MAX or \
            not d2["der"] < d1["der"] - DER_ONE_SPEAKER_GAP:
        raise RuntimeError(f"diarization of the 2-speaker session: {d2} (one speaker: {d1['der']:.4f})")
    work = os.path.join(ROOT, "build", "chip_smoke_diarize")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    t3 = time.perf_counter()
    cli_diarize.main(["--synthetic-session", "12", "--speakers", "3", "--n-speakers", "3", "--run-dir", work,
                      "--device", str(dev)])
    t4 = time.perf_counter()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rec3 = json.loads(f.readlines()[-1])
    shutil.rmtree(work, ignore_errors=True)
    phase(29, f"i-vectors: train_ivector_extractor at its defaults ({ext.ubm.n_components} components, rank "
          f"{ext.rank}) on the training corpus without CMVN ({len(train_nc)} batches) in {ext_s:.2f} s, peak "
          f"{ext_peak:.2f} GiB; {len(ids)} held-out and {len(train_vecs)} training i-vectors in {ext_x_s:.2f} s; "
          f"held-out cosine, centred on the training mean: same speaker {same_cos:.4f}, different {diff_cos:.4f} "
          f"(margin limit {IVEC_MARGIN}); diarization of build_session(2, 10, seed=4): diarizer trained in "
          f"{t1 - t0:.2f} s, diarize_wave {t2 - t1:.2f} s, DER {d2['der']:.4f} (miss {d2['miss']:.4f}, false alarm "
          f"{d2['false_alarm']:.4f}, confusion {d2['confusion']:.4f}; limit {DER_MAX}), one speaker "
          f"{d1['der']:.4f}; the diarize twin on a 3-speaker 12-utterance session (--n-speakers 3) in {t4 - t3:.2f} s: "
          f"{rec3['speakers_found']} speakers found, DER {rec3['der']:.4f}")
    return paths


def adaptation_cli_phase(dev: torch.device, corpus, lexicon) -> dict:
    """Phase 30: ``python -m mogasr_torch.cli.eval --fmllr/--mllr/--vtln
    --bundle`` on the held-out corpus as WAV with a manifest (WER limit),
    ``train_gmm --lda 3`` on a small demo corpus (the checkpoint read back),
    ``transcribe --synthetic-demo --diarize`` and ``diarize
    --synthetic-session``, all at once; then ``eval --fmllr --bundle`` on
    CLI_COUNT_UTTS of them in this process with the launch counts set to 0
    before and read after. Returns the counts."""
    import shutil

    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke_adapt_cli")
    shutil.rmtree(work, ignore_errors=True)
    files = write_cli_corpora(os.path.join(work, "data"), corpus, lexicon)
    wav = ["--manifest", files["manifest"], "--lexicon", files["lexicon"]]
    runs = {
        "eval --fmllr": ("eval", wav + ["--bundle", BUNDLE, "--fmllr"]),
        "eval --mllr": ("eval", wav + ["--bundle", BUNDLE, "--mllr"]),
        "eval --vtln": ("eval", wav + ["--bundle", BUNDLE, "--vtln"]),
        "train_gmm --lda": ("train_gmm", ["--synthetic", "16", "--num-components", "2", "--num-iters", "4",
                                          "--lda", str(LDA_CONTEXT)]),
        "transcribe --diarize": ("transcribe", ["--synthetic-demo", "--diarize", "--num-speakers", "2", "--out",
                                                os.path.join(work, "transcript.jsonl")]),
        "diarize": ("diarize", ["--synthetic-session", "8", "--rttm", os.path.join(work, "session.rttm")]),
    }
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = {}
    t0 = time.perf_counter()
    for name, (module, args) in runs.items():
        run_dir = os.path.join(work, name.replace(" ", "_").replace("-", ""))
        cmd = [sys.executable, "-m", f"mogasr_torch.cli.{module}", *args, "--run-dir", run_dir, "--device", str(dev)]
        procs[name] = (run_dir, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    try:
        zero_launches()
        few = wav + ["--max-utts", str(CLI_COUNT_UTTS), "--device", str(dev)]
        cli_eval.main(few + ["--bundle", BUNDLE, "--fmllr", "--run-dir", os.path.join(work, "counted")])
        launches = launch_counts()
        require_k1_k2_only("eval --fmllr in this process", launches)
        results = {}
        for name, (run_dir, proc) in procs.items():
            _out, err = proc.communicate(timeout=max(ADAPT_CLI_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if proc.returncode != 0:
                raise RuntimeError(f"the CLI twin ({name}) failed ({proc.returncode}): {err[-2000:]}")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                results[name] = [json.loads(line) for line in f]
        all_s = time.perf_counter() - t0
    finally:
        for _run_dir, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)

    def record(name, stage):
        recs = [r for r in results[name] if r["stage"] == stage]
        if len(recs) != 1:
            raise RuntimeError(f"the CLI twin ({name}) logged {results[name]}")
        return recs[0]

    evals = {name: record(name, "eval") for name in ("eval --fmllr", "eval --mllr", "eval --vtln")}
    for name, rec in evals.items():
        if rec["utts"] != len(corpus) or rec["wer"] > MAX_WER:
            raise RuntimeError(f"{name} --bundle: {rec} (WER limit {MAX_WER})")
    lda_rec = record("train_gmm --lda", "train_lda_mllt_done")
    ck = restore_checkpoint(os.path.join(work, "train_gmm_lda", "gmm_lda"))
    if ck["lda_transform"].shape != (LDA_DIM, (2 * LDA_CONTEXT + 1) * 13 + 1) or \
            ck["lda_context"].tolist() != [LDA_CONTEXT] or not np.isfinite(ck["means"]).all():
        raise RuntimeError(f"train_gmm --lda: checkpoint {ck['lda_transform'].shape} {ck['lda_context']}")
    with open(os.path.join(work, "transcript.jsonl")) as f:
        segs = [json.loads(line) for line in f]
    if not segs or any(r.get("speaker") not in (0, 1) for r in segs):
        raise RuntimeError(f"transcribe --diarize: {segs}")
    drec = record("diarize", "diarize_done")
    with open(os.path.join(work, "session.rttm")) as f:
        rttm = f.read().splitlines()
    if len(rttm) != drec["turns"] or not rttm:
        raise RuntimeError(f"diarize: {drec}, {len(rttm)} RTTM lines")
    shutil.rmtree(work, ignore_errors=True)
    phase(30, f"adaptation CLI twins, six runs at once, exited 0 in {all_s:.1f} s: eval --bundle on the "
          f"{len(corpus)} held-out utterances as WAV: " + "; ".join(
              f"{name} WER {r['wer']:.4f} in {r['wall_sec']:.1f} s ({r['utts_per_sec_per_chip']:.1f} utt/s)"
              for name, r in evals.items()) + f" (limit {MAX_WER}); train_gmm --lda {LDA_CONTEXT} (16 utterances): "
          f"loglik {lda_rec['final_avg_loglik']:.3f} in {lda_rec['wall_sec']:.2f} s, gmm_lda read back "
          f"({ck['means'].shape}, transform {ck['lda_transform'].shape}); transcribe --diarize: {len(segs)} segments, "
          f"speakers {[r['speaker'] for r in segs]}; diarize --synthetic-session 8 (3 speakers, threshold "
          f"clustering): {drec['speakers_found']} speakers found, "
          f"DER {drec['der']:.4f}, {drec['turns']} RTTM turns; eval --fmllr --bundle on {CLI_COUNT_UTTS} utterances "
          f"in this process: launches {launches}")
    return launches


def neural_phases(dev, gmm, topo, tied, fcfg, dcfg, graph, corpus, bcfg, train_fbs) -> dict:
    """Phases 31 (CE training of the CLI's LstmAm on the card), 32 (the
    sequence-training Functions on K3 against plain autograd, then MMI and
    sMBR steps), 33 (the trained model's hybrid decode of the held-out
    corpus through K4 and K2, against the untrained model's WER) and 34
    (ConformerAm: CE steps, a hybrid decode, card against CPU). Returns the
    launch counts of each path and the kernels line's entries."""
    import copy

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda
    from mogasr_torch.am import nn_seq
    from mogasr_torch.am import train_nn as ttrain
    from mogasr_torch.am.neural import build_model, frame_ce_loss, posteriors_to_loglik, state_priors
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.smbr import smbr_quantities
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder.viterbi import graphs_to_torch
    from mogasr_torch.hmm import graph as gr
    from mogasr_torch.hmm import triphone as tri

    lex = topo.lexicon
    S, D = gmm.means.shape[0], gmm.means.shape[2]
    align_fn = lambda pids: tri.align_graph_cd(tied, pids)  # noqa: E731

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    # ---- phase 31: CE training
    params = gmm_cuda.kernel_params(gmm, "float32")
    zero_launches()
    align_ms, labels = wall(lambda: [pipe.align_batch(fb, gmm, lex, topo, align_fn=align_fn, params=params)[1]
                                     for fb in train_fbs])
    align_launches = launch_counts()
    require_k1_k2_only("the CE labels' alignment", align_launches)
    priors = state_priors(np.concatenate([lab.cpu().numpy().reshape(-1) for lab in labels]), S)
    lp = torch.as_tensor(priors, device=dev)
    cfg = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=NN_LR, num_nn_steps=NN_STEPS)
    model = init_(build_model("lstm", S, cfg, D), torch.Generator().manual_seed(0)).to(dev)
    untrained = copy.deepcopy(model)
    train_set = [(fb, lab) for fb, lab in zip(train_fbs, labels) if fb.feats.shape[1] <= NN_TRAIN_T]
    by_width = {}
    for fb, lab in train_set:
        by_width.setdefault(fb.feats.shape[1], []).append((fb, lab))
    merged = []
    for group in by_width.values():
        for k in range(0, len(group), NN_MERGE):
            part = group[k:k + NN_MERGE]
            merged.append((pipe.FeatBatch([u for fb, _l in part for u in fb.utt_ids],
                                          torch.cat([fb.feats for fb, _l in part]),
                                          torch.cat([fb.n_frames for fb, _l in part]),
                                          [w for fb, _l in part for w in fb.words]),
                           torch.cat([lab for _fb, lab in part])))
    merged = [merged[i] for i in np.random.default_rng(0).permutation(len(merged))]
    fb0, lab0 = train_set[0]
    refusal = None
    with torch.enable_grad():
        try:
            model(fb0.feats, fb0.n_frames)  # K4 in a forward that needs a gradient
        except RuntimeError as err:
            refusal = str(err)
        if refusal is None or "K4" not in refusal:
            raise RuntimeError(f"K4 ran a forward whose result needs a gradient: {refusal}")
        logits, _aux = ttrain.train_logits(model, fb0.feats, fb0.n_frames)
        frame_ce_loss(logits, lab0)[0].backward()
    no_grad = [n for n, p in model.named_parameters() if p.grad is None or float(p.grad.abs().sum()) == 0.0]
    if no_grad:
        raise RuntimeError(f"CE training: parameters without a gradient: {no_grad}")
    model.zero_grad(set_to_none=True)
    state, step = ttrain.init_train_state(model, cfg), ttrain.make_train_step(cfg)
    zero_launches()
    metrics, step_ms = [], []
    for i in range(NN_STEPS):
        fb, lab = merged[i % len(merged)]
        ms, (state, m) = wall(lambda: step(state, fb.feats, fb.n_frames, lab))
        step_ms.append(ms)
        metrics.append(m)
    ce_launches = launch_counts()
    if any(ce_launches.values()):
        raise RuntimeError(f"CE training launched kernels: {ce_launches} (K4 has no backward)")
    if not np.isfinite([m["loss"] for m in metrics]).all():
        raise RuntimeError(f"CE training: loss not finite: {[m['loss'] for m in metrics]}")
    frames = [int(fb.n_frames.sum()) for fb, _lab in merged]
    ce = {"steps": NN_STEPS, "ms_per_step": float(np.median(step_ms[1:])), "first_step_ms": step_ms[0],
          "loss_first": metrics[0]["loss"], "loss_last": metrics[-1]["loss"],
          "frame_acc_first": metrics[0]["frame_acc"], "frame_acc_last": metrics[-1]["frame_acc"],
          "batches": len(merged), "rows": NN_MERGE * train_fbs[0].feats.shape[0],
          "max_T": max(fb.feats.shape[1] for fb, _lab in merged), "frames_per_step": float(np.mean(frames))}
    phase(31, f"CE training of LstmAm {S} x {NN_HIDDEN} x {model.layers} on the card: the {len(train_fbs)} training "
              f"batches aligned with the bundle in {align_ms:.0f} ms (launches {align_launches}); "
              f"{NN_STEPS} steps (lr {NN_LR:g}) over the {len(train_set)} batches of at most {NN_TRAIN_T} frames, "
              f"{NN_MERGE} of one width a step ({len(merged)} batches of up to {ce['rows']} rows, "
              f"{ce['frames_per_step']:.0f} frames a step on average): {ce['ms_per_step']:.1f} ms a step "
              f"(median; first {step_ms[0]:.0f} ms), loss {ce['loss_first']:.3f} -> {ce['loss_last']:.3f}, frame "
              f"accuracy {ce['frame_acc_first']:.3f} -> {ce['frame_acc_last']:.3f}; every parameter got a nonzero "
              f"gradient; no kernel launched in training; K4 in a training forward raised: {refusal[:80]}...")

    # ---- phase 32: sequence training through K3
    fbs_, labs_ = min(train_set, key=lambda it: it[0].feats.shape[1])
    B = fbs_.feats.shape[0]
    num = graphs_to_torch(pipe.build_align_graphs(fbs_.words, lex, topo, align_fn=align_fn), dev)
    den = graphs_to_torch(gr.batch_graphs([graph] * B), dev)
    with torch.no_grad():
        ll = posteriors_to_loglik(model(fbs_.feats, fbs_.n_frames), lp)
    # (the criterion with a gradient, the gradient's tolerance, the value's relative one)
    cases = {"loglik, align graphs (chain arm)": (lambda x, k: nn_seq.fb_loglik(x, num, fbs_.n_frames, SEQ_SCALE, k),
                                                  SEQ_CHAIN_TOL, FB_LOGLIK_RTOL),
             "loglik, CD word loop (general arm)": (lambda x, k: nn_seq.fb_loglik(x, den, fbs_.n_frames, SEQ_SCALE, k),
                                                    dict(rtol=0.0, atol=SEQ_LOOP_ATOL), FB_LOGLIK_RTOL),
             "E[acc], CD word loop (general arm)": (lambda x, k: nn_seq.smbr_accuracy(x, den, labs_, fbs_.n_frames,
                                                                                      SEQ_SCALE, k),
                                                    dict(rtol=0.0, atol=SEQ_LOOP_ATOL), SEQ_ACC_RTOL)}
    seq_err, seq_ms = {}, {}
    for name, (fn, tol, value_rtol) in cases.items():
        out = {}
        for use_kernels in (True, False):
            x = ll.clone().requires_grad_()

            def run():
                with torch.enable_grad():
                    y = fn(x, use_kernels)
                    y.sum().backward()
                return y.detach()

            ms, y = wall(run)
            out[use_kernels] = (y, x.grad)
            seq_ms[(name, use_kernels)] = ms
        val_err = float((out[True][0] - out[False][0]).abs().max() / out[False][0].abs().max())
        grad_err = float((out[True][1] - out[False][1]).abs().max())
        seq_err[name] = (val_err, grad_err)
        if val_err > value_rtol or not torch.allclose(out[True][1], out[False][1], **tol):
            raise RuntimeError(f"{name}: the Function on K3 against plain autograd: value {val_err:.3g} relative, "
                               f"gradient max |err| {grad_err:.3g} (tolerance {tol})")
    smbr_bwd_ms, _q = wall(lambda: smbr_quantities(ll, den, labs_, fbs_.n_frames, SEQ_SCALE, S))
    seq_model = copy.deepcopy(model)
    zero_launches()
    mmi_ms, (_m, mmi_hist) = wall(lambda: nn_seq.finetune_nn_mmi(
        [fbs_], lex, topo, seq_model, priors, cfg, steps=SEQ_STEPS, acoustic_scale=SEQ_SCALE, den_graph=graph,
        align_fn=align_fn))
    smbr_ms, (_m, smbr_hist) = wall(lambda: nn_seq.finetune_nn_smbr(
        [(fbs_, labs_)], lex, topo, seq_model, priors, cfg, steps=SEQ_STEPS, acoustic_scale=SEQ_SCALE,
        den_graph=graph))
    seq_launches = launch_counts()
    if min(seq_launches[k] for k in ("fb_forward", "fb_backward", "fb_combine")) == 0 or \
            seq_launches["lstm_scan"] or not np.isfinite(mmi_hist + smbr_hist).all():
        raise RuntimeError(f"sequence training: launches {seq_launches}, MMI {mmi_hist}, sMBR {smbr_hist}")
    seq = {"batch": [B, int(fbs_.feats.shape[1]), int(den["emit_id"].shape[1])],
           "mmi_ms_per_step": mmi_ms / SEQ_STEPS, "smbr_ms_per_step": smbr_ms / SEQ_STEPS,
           "smbr_backward_ms": smbr_bwd_ms, "smbr_backward_share": smbr_bwd_ms / (smbr_ms / SEQ_STEPS),
           "mmi_per_frame": mmi_hist, "acc_per_frame": smbr_hist,
           "errors": {k: {"value_rel": v, "grad_max_abs": g} for k, (v, g) in seq_err.items()},
           "function_ms": {k: seq_ms[(k, True)] for k in cases}, "plain_ms": {k: seq_ms[(k, False)] for k in cases}}
    phase(32, f"sequence training on a batch of B={B} T={seq['batch'][1]} (CD word loop J={seq['batch'][2]}): "
              + "; ".join(f"{k}: value {v:.2g} rel, gradient max |err| {g:.3g}, Function {seq_ms[(k, True)]:.0f} ms "
                          f"(plain autograd {seq_ms[(k, False)]:.0f} ms)" for k, (v, g) in seq_err.items())
              + f" (limits: chain {SEQ_CHAIN_TOL}, word loop atol {SEQ_LOOP_ATOL}); {SEQ_STEPS} MMI steps "
              f"{seq['mmi_ms_per_step']:.0f} ms a step (criterion {[round(v, 4) for v in mmi_hist]}), {SEQ_STEPS} sMBR "
              f"steps {seq['smbr_ms_per_step']:.0f} ms a step (accuracy {[round(v, 4) for v in smbr_hist]}), its "
              f"backward's plain frame loops {smbr_bwd_ms:.0f} ms ({100 * seq['smbr_backward_share']:.0f}% of a "
              f"step); launches {seq_launches}")

    # ---- phase 33: the trained hybrid decode of the held-out corpus
    held = pipe.featurize(corpus, fcfg, bcfg, dev)
    zero_launches()
    dec_ms, res = wall(lambda: pipe.evaluate(held, None, lex, topo, dcfg, scorer=pipe.make_nn_scorer(model, priors),
                                             graph=graph))
    decode_launches = launch_counts()
    if min(decode_launches["lstm_scan"], decode_launches["viterbi"]) == 0 or \
            any(v for k, v in decode_launches.items() if k not in ("lstm_scan", "viterbi")):
        raise RuntimeError(f"the trained hybrid decode: launches {decode_launches} (K4 and K2 only)")
    base = pipe.evaluate(held, None, lex, topo, dcfg, scorer=pipe.make_nn_scorer(untrained, priors), graph=graph)
    if not res["wer"] < base["wer"]:
        raise RuntimeError(f"the trained LstmAm's held-out WER {res['wer']:.4f} does not beat the untrained "
                           f"model's {base['wer']:.4f}")
    hybrid = {"wer": res["wer"], "untrained_wer": base["wer"], "utts": res["n_utts"], "ms": dec_ms,
              "sub_del_ins": [res["sub"], res["del"], res["ins"]],
              "untrained_sub_del_ins": [base["sub"], base["del"], base["ins"]]}
    phase(33, f"hybrid decode of the {res['n_utts']} held-out utterances with the trained LstmAm (K4, K2): WER "
              f"{res['wer']:.4f} (sub/del/ins {hybrid['sub_del_ins']}) against the untrained model's "
              f"{base['wer']:.4f} ({hybrid['untrained_sub_del_ins']}); {dec_ms:.0f} ms; launches {decode_launches}")

    # ---- phase 34: ConformerAm
    ccfg = TrainConfig(nn_arch="conformer", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=CONF_LR,
                       num_nn_steps=CONF_STEPS)
    conf = init_(build_model("conformer", S, ccfg, D), torch.Generator().manual_seed(0)).to(dev)
    cstate, cstep = ttrain.init_train_state(conf, ccfg), ttrain.make_train_step(ccfg)
    cmetrics, cstep_ms = [], []
    zero_launches()
    for i in range(CONF_STEPS):
        fb, lab = merged[i % len(merged)]
        ms, (cstate, m) = wall(lambda: cstep(cstate, fb.feats, fb.n_frames, lab))
        cstep_ms.append(ms)
        cmetrics.append(m)
    cdec_ms, cres = wall(lambda: pipe.evaluate(held, None, lex, topo, dcfg, scorer=pipe.make_nn_scorer(conf, priors),
                                               graph=graph))
    conf_launches = launch_counts()
    if conf_launches["viterbi"] == 0 or any(v for k, v in conf_launches.items() if k != "viterbi") or \
            not np.isfinite([m["loss"] for m in cmetrics]).all():
        raise RuntimeError(f"ConformerAm: launches {conf_launches} (K2 only), losses {[m['loss'] for m in cmetrics]}")
    few = held[0]
    x, nf = few.feats[:CONF_CPU_UTTS], few.n_frames[:CONF_CPU_UTTS]
    with torch.no_grad():
        conf.eval()
        on_card = conf(x, nf).cpu()
        on_cpu = copy.deepcopy(conf).cpu()(x.cpu(), nf.cpu())
    valid = (torch.arange(x.shape[1])[None, :] < nf.cpu()[:, None])
    conf_err = float((on_card - on_cpu).abs()[valid].max())
    if conf_err > CONF_CPU_ATOL:
        raise RuntimeError(f"ConformerAm on the card against the CPU: max |err| {conf_err:.3g} > {CONF_CPU_ATOL}")
    conformer = {"steps": CONF_STEPS, "ms_per_step": float(np.median(cstep_ms[1:])),
                 "loss_first": cmetrics[0]["loss"], "loss_last": cmetrics[-1]["loss"],
                 "frame_acc_last": cmetrics[-1]["frame_acc"], "wer": cres["wer"], "decode_ms": cdec_ms,
                 "cpu_max_abs_err": conf_err}
    phase(34, f"ConformerAm (d {conf.enc.d_model}, {NN_LAYERS} blocks, 4 heads, kernel 15) on the card: "
              f"{CONF_STEPS} CE steps {conformer['ms_per_step']:.1f} ms a step, loss {conformer['loss_first']:.3f} "
              f"-> {conformer['loss_last']:.3f}; hybrid decode of the held-out set WER {cres['wer']:.4f} in "
              f"{cdec_ms:.0f} ms; its logits on {CONF_CPU_UTTS} utterances within {conf_err:.3g} of the CPU's "
              f"(atol {CONF_CPU_ATOL}); launches {conf_launches}")
    return {"paths": {"nn_align": align_launches, "nn_ce": ce_launches, "nn_seq": seq_launches,
                      "nn_decode": decode_launches, "conformer": conf_launches},
            "ce": ce, "seq": seq, "hybrid": hybrid, "conformer": conformer, "model": model}


def nn_cli_phase(dev: torch.device) -> dict:
    """Phase 35: the neural-AM twins in this process, the launch counts set to
    0 before and read after: ``train_nn --arch lstm`` with i-vectors, MMI,
    periodic checkpoints and their average, then ``decode --am lstm
    --nn-ckpt --ivector-ckpt``; a second ``train_nn`` without i-vectors,
    then ``eval --am lstm --nn-ckpt`` on it."""
    import shutil

    from mogasr_torch.cli import decode as cli_decode
    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.cli import train_nn as cli_train_nn
    from mogasr_torch.utils.checkpoint import all_steps

    work = os.path.join(ROOT, "build", "chip_smoke_nn_cli")
    shutil.rmtree(work, ignore_errors=True)
    corpus = ["--synthetic-v2", "32", "--synthetic-seed", "5", "--device", str(dev)]
    nn = ["--am", "lstm", "--nn-hidden", str(NN_HIDDEN), "--nn-layers", str(NN_LAYERS)]
    arch = ["--arch", "lstm", "--hidden", str(NN_HIDDEN), "--layers", str(NN_LAYERS)]
    iv, plain = os.path.join(work, "iv"), os.path.join(work, "plain")
    zero_launches()
    t0 = time.perf_counter()
    cli_train_nn.main(corpus + arch + ["--steps", "4", "--bootstrap-iters", "2", "--bootstrap-components", "1",
                                       "--ivector-dim", "8",
                                "--ivector-components", "16", "--seq-mmi-steps", "2", "--save-every", "2",
                                "--average-last", "2", "--run-dir", iv])
    cli_decode.main(corpus + nn + ["--nn-ckpt", os.path.join(iv, "nn_lstm"), "--ivector-ckpt",
                                   os.path.join(iv, "ivector_extractor"), "--ivector-dim", "8",
                                   "--ivector-components", "16", "--run-dir", os.path.join(work, "decode")])
    cli_train_nn.main(corpus + arch + ["--steps", "2", "--bootstrap-iters", "1", "--bootstrap-components", "1",
                                       "--run-dir", plain])
    cli_eval.main(corpus + nn + ["--nn-ckpt", os.path.join(plain, "nn_lstm"), "--run-dir", os.path.join(work, "eval")])
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if min(launches[k] for k in ("gmm_score", "viterbi", "fb_forward", "fb_backward", "fb_combine", "lstm_scan")) == 0:
        raise RuntimeError(f"the neural CLI twins did not go through every kernel of their path: {launches}")
    steps = all_steps(os.path.join(iv, "nn_lstm"))
    if steps != [2, 4, 5]:
        raise RuntimeError(f"train_nn --save-every 2 --seq-mmi-steps 2 --average-last 2 saved steps {steps}")
    recs = {}
    for name in ("decode", "eval"):
        with open(os.path.join(work, name, "metrics.jsonl")) as f:
            recs[name] = json.loads(f.read().splitlines()[-1])
        if recs[name]["utts"] != 32 or not np.isfinite(recs[name]["wer"]):
            raise RuntimeError(f"{name} --am lstm --nn-ckpt: {recs[name]}")
    phase(35, f"neural CLI twins in this process, {seconds:.1f} s: train_nn --arch lstm (--ivector-dim 8, "
              f"--seq-mmi-steps 2, --save-every 2, --average-last 2: steps {steps}), decode --am lstm --nn-ckpt "
              f"--ivector-ckpt WER {recs['decode']['wer']:.4f}, train_nn without i-vectors, eval --am lstm "
              f"--nn-ckpt WER {recs['eval']['wer']:.4f} (4 and 2 steps: no limit); launches {launches}")
    return launches


def k4_layer_times(cell, x, n_frames, h0=None, c0=None, reps: int = 5) -> dict:
    """K4 on one LSTM layer (its input gates from ``x``) against the plain
    recurrence, with its bound, and the whole layer (input GEMM + K4) beside
    cuDNN's nn.LSTM on the rows with frames (its outputs held to K4's on the
    valid frames); with (h0, c0) the carry arm, whose rows without frames
    must keep their carries bitwise. Raises past K4_ATOL."""
    from mogasr_torch.am import fast_lstm, lstm_cuda
    from mogasr_torch.am import neural as tn

    dev = x.device
    B, T = x.shape[:2]
    H = cell.w_rec.shape[0]
    carry = h0 is not None
    kw = dict(h0=h0, c0=c0, return_carry=True) if carry else {}
    with torch.no_grad():
        xg = cell.input_gates(x, "float32")
        ms, y_k = timed(lambda: lstm_cuda.lstm_layer(xg, cell.w_rec, n_frames, "float32", **kw), reps)
        device_ms = queued_ms(lambda: lstm_cuda.lstm_layer(xg, cell.w_rec, n_frames, "float32", **kw))
        plain_ms, y_p = timed(lambda: fast_lstm.lstm_layer(xg, cell.w_rec, n_frames, "float32", **kw),
                              max(reps // 5, 1))
        vmask = tn.valid_mask(n_frames, T, dev)
        outs = [(y_k[0], y_p[0]), (y_k[1][0], y_p[1][0]), (y_k[1][1], y_p[1][1])] if carry else [(y_k, y_p)]
        err = max(float((a - b)[vmask].abs().max()) if a.dim() == 3 else float((a - b).abs().max())
                  for a, b in outs)
        idle = n_frames == 0
        if carry and not (torch.equal(y_k[1][0][idle], h0[idle]) and torch.equal(y_k[1][1][idle], c0[idle])):
            raise RuntimeError(f"K4's carry arm at B={B} T={T} H={H}: a row without frames moved its carries")
        cudnn = torch.nn.LSTM(x.shape[2], H, batch_first=True).to(dev)
        cudnn.weight_ih_l0.copy_(cell.w_in.T)   # torch's gate order i, f, g, o is flax's
        cudnn.weight_hh_l0.copy_(cell.w_rec.T)
        cudnn.bias_ih_l0.zero_()
        cudnn.bias_hh_l0.copy_(cell.bias)
        live = (~idle).nonzero()[:, 0]
        lens = n_frames[live].to(device="cpu", dtype=torch.int64)
        init = (h0[live][None], c0[live][None]) if carry else None

        def cudnn_layer():
            packed = torch.nn.utils.rnn.pack_padded_sequence(x[live], lens, batch_first=True, enforce_sorted=False)
            return cudnn(packed, init)

        lib_ms, (lib_out, _carry) = timed(cudnn_layer, reps)
        lib_y = torch.nn.utils.rnn.pad_packed_sequence(lib_out, batch_first=True, total_length=T)[0]
        lib_diff = float((lib_y - (y_k[0] if carry else y_k)[live])[vmask[live]].abs().max())
        layer_ms, _ = timed(lambda: cell(x, n_frames), reps)
    if err > K4_ATOL["float32"]:
        raise RuntimeError(f"K4 at B={B} T={T} H={H} off the plain recurrence by {err}")
    valid = int(n_frames.sum())
    b = bound(valid * 4 * H * 4 + H * 4 * H * 4 + B * 4 + B * T * H * 4 + (4 * B * H * 4 if carry else 0),
              valid * H * (2 * 4 * H + K4_GATE_OPS), "float32")
    return {"shape": [B, T, H], "idle_rows": int(idle.sum()), "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
            "layer_ms": layer_ms, "library_max_abs_diff": lib_diff}


def ctc_batches(train_fbs):
    """Phase 31's merged training batches for CTC: the live rows of NN_MERGE
    training batches of one width (at most NN_TRAIN_T frames) at once, in a
    seeded order."""
    from mogasr_torch import pipeline as pipe

    by_width = {}
    for fb in train_fbs:
        if fb.feats.shape[1] <= NN_TRAIN_T:
            by_width.setdefault(fb.feats.shape[1], []).append(pipe.live_rows(fb))
    merged = []
    for group in by_width.values():
        for k in range(0, len(group), NN_MERGE):
            part = group[k:k + NN_MERGE]
            merged.append(pipe.FeatBatch([u for fb in part for u in fb.utt_ids], torch.cat([fb.feats for fb in part]),
                                         torch.cat([fb.n_frames for fb in part]), [w for fb in part for w in fb.words]))
    return [merged[i] for i in np.random.default_rng(0).permutation(len(merged))]


def ctc_phases(dev: torch.device, topo, fcfg, corpus, bcfg, train_fbs, ce_model) -> dict:
    """Phases 36-41: the CTC loss on K3 against the plain recursion, CTC
    training of the full-width LstmAm, the held-out decodes (greedy on K4; the
    CTC word loop on K4 then K2's word-loop skip arm), the online decode on
    K4's carry arm and K2's chunk skip arm, BPE CTC and the three prefix
    beams, distillation and the MPC warm start. Returns each path's launch
    counts and the kernels line's CTC sub-entries."""
    import copy

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import ctc, lstm_cuda
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.pretrain import pretrain_mpc, transfer_pretrained
    from mogasr_torch.config import DecodeConfig, TrainConfig
    from mogasr_torch.data.bpe import train_bpe
    from mogasr_torch.decoder import biasing, online, viterbi_cuda
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder import forward_backward as fbd
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.lm import unit_ngram

    lex = topo.lexicon
    V, D = lex.n_phones + 1, fcfg.feat_dim
    blank = V - 1
    fb_names = ("fb_forward_kernel", "fb_backward_kernel", "fb_combine_kernel")
    arm_k3 = {fb_cuda.ARM_CHAIN: "chain", fb_cuda.ARM_BLOCK: "block", fb_cuda.ARM_GENERAL: "general"}
    arm_k2 = {viterbi_cuda.ARM_CHAIN: "chain", viterbi_cuda.ARM_LOOP: "word loop", viterbi_cuda.ARM_BLOCK: "block"}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def zero():
        zero_launches()
        viterbi_cuda.CHUNK_LAUNCHES = viterbi_cuda.BACKTRACE_LAUNCHES = lstm_cuda.CARRY_LAUNCHES = 0

    def counts():
        c = launch_counts()
        c.update(viterbi_chunk=viterbi_cuda.CHUNK_LAUNCHES, viterbi_backtrace=viterbi_cuda.BACKTRACE_LAUNCHES,
                 lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
        return c

    def only(name, c, allowed):
        if any(v for k, v in c.items() if k not in allowed) or min(c[k] for k in allowed) == 0:
            raise RuntimeError(f"{name}: launches {c} (only and every one of {allowed})")

    merged = ctc_batches(train_fbs)

    def encode(words):
        return ctc.ctc_labels_from_words(lex, words)

    labeled = pipe._pack_ctc_targets(merged, encode)
    cfg = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=CTC_LR,
                      num_nn_steps=CTC_SCHEDULE)
    untrained = pipe._ctc_model("lstm", lex.n_phones, cfg, merged)
    model = copy.deepcopy(untrained)
    warm_sd, copied, total = transfer_pretrained(ce_model.state_dict(), model.state_dict())
    model.load_state_dict(warm_sd)
    warm0 = copy.deepcopy(model)

    # ---- phase 36: the loss through K3 against the plain recursion
    fb, labels, nl = labeled[0]
    with torch.no_grad():
        logits = model(fb.feats, fb.n_frames)
    out, loss_ms = {}, {}
    for use_kernels in (True, False):
        x = logits.clone().requires_grad_()

        def run():
            with torch.enable_grad():
                nll = ctc.ctc_loss(x, fb.n_frames, labels, nl, use_kernels=use_kernels)
                nll.sum().backward()
            return nll.detach()

        loss_ms[use_kernels], nll = wall(run)
        out[use_kernels] = (nll, x.grad)
        if use_kernels:
            k3_arms = sorted({arm_k3[a] for a in fb_cuda.LAST_ARMS.flatten().tolist()})
    # the float64 recursion under autograd: the gradient both float32 routes are held to
    x64 = logits.double().requires_grad_()
    with torch.enable_grad():
        ctc.ctc_loss_plain(torch.log_softmax(x64, -1), fb.n_frames, labels, nl, blank).sum().backward()
    loss_err = float(((out[True][0] - out[False][0]).abs() / out[False][0].abs()).max())
    grad_err = float((out[True][1] - out[False][1]).abs().max())
    grad64 = {k: float((out[k][1].double() - x64.grad).abs().max()) for k in (True, False)}
    grad_limit = max(CTC_GRAD_RATIO * grad64[False], FB_ERR_FLOOR)
    if loss_err > CTC_LOSS_RTOL or grad64[True] > min(grad_limit, FB_POST64_ATOL) or k3_arms != ["chain"]:
        raise RuntimeError(f"the CTC loss on K3 against the plain recursion: loss {loss_err:.3g} relative (limit "
                           f"{CTC_LOSS_RTOL}), gradient {grad64[True]:.3g} from float64 (plain float32 "
                           f"{grad64[False]:.3g}; limit {min(grad_limit, FB_POST64_ATOL):.3g}), arms {k3_arms}")
    # rows without labels, without frames and with labels that cannot fit, on the card
    rng = np.random.default_rng(36)
    e_logits = torch.as_tensor(rng.standard_normal((6, 7, V)).astype(np.float32), device=dev)
    e_nf = torch.as_tensor([7, 0, 3, 7, 2, 5], device=dev)
    e_lab = torch.as_tensor([[0, 1, -1, -1], [2, -1, -1, -1], [1, 1, 2, 3], [-1] * 4, [0, 1, 2, -1], [3, 3, -1, -1]],
                            device=dev)
    e_nl = torch.as_tensor([2, 1, 4, 0, 3, 2], device=dev)
    edge = {}
    e_fit, e_short = [0, 1, 3, 5], [2, 4]  # rows 2 and 4 cannot fit: K3's gradient there is 0
    for use_kernels in (True, False):
        x = e_logits.clone().requires_grad_()
        with torch.enable_grad():
            obj, _mean = ctc.masked_mean_objective(ctc.ctc_loss(x, e_nf, e_lab, e_nl, use_kernels=use_kernels),
                                                   e_nf, e_nl)
            obj.backward()
        edge[use_kernels] = (obj.detach(), x.grad)
    edge_err = (float((edge[True][0] - edge[False][0]).abs() / edge[False][0].abs()),
                float((edge[True][1][e_fit] - edge[False][1][e_fit]).abs().max()))
    short_grad = float(edge[True][1][e_short].abs().max())
    if edge_err[0] > CTC_LOSS_RTOL or edge_err[1] > CTC_GRAD_ATOL or not torch.isfinite(edge[True][1]).all() or \
            short_grad != 0.0:
        raise RuntimeError(f"the CTC objective on the edge rows: K3 route against plain {edge_err}, gradient "
                           f"{short_grad} on the rows that cannot fit (must be 0)")
    logp = torch.log_softmax(logits, -1)
    # the library yardstick: torch's CTC loss forward + backward on the same
    # log posteriors (time-major, the targets unpadded by their lengths)
    lp_tbc = logp.detach().transpose(0, 1).contiguous()

    def library_loss():
        xl = lp_tbc.clone().requires_grad_()
        with torch.enable_grad():
            torch.nn.functional.ctc_loss(xl, labels.clamp(min=0).long(), fb.n_frames.long(), nl.long(), blank=blank,
                                         reduction="sum", zero_infinity=True).backward()
        return xl.grad

    lib_loss_ms, _ = timed(library_loss, 5)
    graphs = ctc.ctc_label_graphs(labels, nl, blank)
    nf1 = fb.n_frames.clamp(min=1)
    k3_dev = kernel_device_ms(lambda: fb_cuda.forward_backward(logp, graphs, nf1), fb_names, 5)
    k3_plain_ms, _ = timed(lambda: fbd.forward_backward(logp, graphs, nf1), 1)
    k3_bounds = fb_bounds({**graphs, "n_states": 2 * nl + 1}, fb.n_frames, fb.feats.shape[1])
    k3_ll_err = float((fb_cuda.forward_backward(logp, graphs, nf1).loglik
                       - fbd.forward_backward(logp, graphs, nf1).loglik).abs().max())
    Bl, Tl, Jl = fb.feats.shape[0], fb.feats.shape[1], graphs["emit_id"].shape[1]
    max_labels = max(int(n.max()) for _f, _l, n in labeled)
    phase(36, f"the CTC loss on a training batch of B={Bl} T={Tl} (label graphs J={Jl}, K3's {k3_arms} arm with "
              f"skips): through K3 against the plain recursion on the card, loss {loss_err:.3g} relative (limit "
              f"{CTC_LOSS_RTOL}), gradient max |err| {grad_err:.3g}; from the float64 recursion's gradient K3's "
              f"{grad64[True]:.3g}, plain float32's {grad64[False]:.3g} (limit {min(grad_limit, FB_POST64_ATOL):.3g}: "
              f"{CTC_GRAD_RATIO:g} x plain's, at most {FB_POST64_ATOL}); the edge rows' limits {CTC_LOSS_RTOL} and "
              f"{CTC_GRAD_ATOL}; loss and backward "
              f"{loss_ms[True]:.1f} ms (plain {loss_ms[False]:.1f} ms; torch's ctc_loss forward + backward on the "
              f"same log posteriors {lib_loss_ms:.3f} ms); the kernels K3f "
              f"{k3_dev['fb_forward_kernel']:.3f}"
              f" ms, K3b {k3_dev['fb_backward_kernel']:.3f} ms, combine {k3_dev['fb_combine_kernel']:.3f} ms (plain "
              f"passes {k3_plain_ms:.1f} ms; bounds {k3_bounds['fwd'][0]:.4f}, {k3_bounds['bwd'][0]:.4f}, "
              f"{k3_bounds['combine'][0]:.4f} ms); the edge rows (no labels, no frames, two that cannot fit) "
              f"objective {edge_err[0]:.3g} relative, gradient {edge_err[1]:.3g} on the rows that fit and "
              f"{short_grad:g} on the two that cannot; the longest label sequence "
              f"{max_labels} phones (K3's chain arm takes 511)")

    # ---- phase 37: CTC training of the full-width LstmAm
    state, step = ctc.init_ctc_train_state(model, cfg), ctc.make_ctc_train_step(cfg)
    zero()
    metrics, step_ms = [], []
    for i in range(CTC_STEPS):
        fb_i, lab_i, nl_i = labeled[i % len(labeled)]
        ms, (state, m) = wall(lambda: step(state, fb_i.feats, fb_i.n_frames, lab_i, nl_i))
        step_ms.append(ms)
        metrics.append(m)
    train_launches = counts()
    only("CTC training", train_launches, ("fb_forward", "fb_backward", "fb_combine"))
    losses = [m["loss"] for m in metrics]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"CTC training: losses {losses}")
    frames = float(np.mean([int(f.n_frames.sum()) for f, _l, _n in labeled]))
    train = {"steps": CTC_STEPS, "ms_per_step": float(np.median(step_ms[1:])), "first_step_ms": step_ms[0],
             "loss_first": losses[0], "loss_last": losses[-1], "frames_per_step": frames,
             "warm_start_copied": [copied, total]}
    phase(37, f"CTC training of LstmAm {V} x {NN_HIDDEN} x {model.layers} on the card, its encoder warm-started from "
              f"phase 31's CE model ({copied} of {total} tensors copied, the head fresh): {CTC_STEPS} steps of a "
              f"{CTC_SCHEDULE}-step schedule (peak lr {CTC_LR:g}) over {len(labeled)} batches ({frames:.0f} frames a "
              f"step on average): "
              f"{train['ms_per_step']:.1f} ms a step (median; first {step_ms[0]:.0f} ms), loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; launches {train_launches}")

    # ---- phase 38: the held-out decodes
    held = pipe.featurize(corpus, fcfg, bcfg, dev)
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    graph = ctc.ctc_decode_graph(lex, dcfg)

    def phones_of(words):
        return [lex.phones[p] for p in lex.words_to_phone_ids(words, interword_sil=False, edge_sil=False,
                                                              oov="skip")]

    def greedy_per(m):
        frames_fn = ctc.make_ctc_frames_fn(m)
        refs, hyps = [], []
        for f in held:
            fr, n_dec = frames_fn(f.feats, f.n_frames)
            for b, seq in enumerate(ctc.ctc_collapse_frames(fr, n_dec, blank)[: f.size]):
                refs.append(phones_of(f.words[b]))
                hyps.append([lex.phones[u] for u in seq])
        return corpus_wer(refs, hyps)[0]

    zero()
    greedy_ms, per = wall(lambda: greedy_per(model))
    greedy_launches = counts()
    only("the greedy decode", greedy_launches, ("lstm_scan",))
    zero()
    graph_ms, res = wall(lambda: pipe.evaluate(held, None, lex, None, dcfg, scorer=ctc.make_ctc_scorer(model),
                                               graph=graph))
    graph_launches = counts()
    only("the CTC word-loop decode", graph_launches, ("lstm_scan", "viterbi"))
    base = pipe.evaluate(held, None, lex, None, dcfg, scorer=ctc.make_ctc_scorer(untrained), graph=graph)
    pre = pipe.evaluate(held, None, lex, None, dcfg, scorer=ctc.make_ctc_scorer(warm0), graph=graph)
    if not res["wer"] < 0.5 * base["wer"]:
        raise RuntimeError(f"the trained CTC model's held-out WER {res['wer']:.4f} is not below half the "
                           f"untrained model's {base['wer']:.4f}")
    fbw = max(held, key=lambda f: f.feats.shape[1])
    Bw, Tw = fbw.feats.shape[:2]
    lpw = ctc.make_ctc_scorer(model)(fbw)
    graphs_w = pipe.decode_graphs(graph, Bw, dev)[1]
    got = viterbi_cuda.viterbi(lpw, graphs_w, fbw.n_frames, acoustic_scale=1.0)
    k2_arms = sorted({arm_k2[a] for a in viterbi_cuda.LAST_ARMS.tolist()})
    want = vit.viterbi(lpw, graphs_w, fbw.n_frames, acoustic_scale=1.0)
    lw = fbw.n_frames > 0
    if not (torch.equal(got.path[lw], want.path[lw]) and torch.equal(got.entered[lw], want.entered[lw])
            and torch.equal(got.score[lw], want.score[lw])) or k2_arms != ["word loop"]:
        raise RuntimeError(f"K2's word-loop skip arm on the CTC word loop differs from the plain Viterbi (arms "
                           f"{k2_arms})")
    k2_ms, _ = timed(lambda: viterbi_cuda.viterbi(lpw, graphs_w, fbw.n_frames, acoustic_scale=1.0), 5)
    k2_plain_ms, _ = timed(lambda: vit.viterbi(lpw, graphs_w, fbw.n_frames, acoustic_scale=1.0), 1)
    k2_b = k2_bound(graphs_w, fbw.n_frames, Tw)
    k4 = k4_layer_times(model.cells[0], fbw.feats, fbw.n_frames)
    decode = {"graph_wer": res["wer"], "untrained_graph_wer": base["wer"], "warm_start_graph_wer": pre["wer"],
              "greedy_per": per, "greedy_ms": greedy_ms, "graph_ms": graph_ms, "utts": res["n_utts"],
              "sub_del_ins": [res["sub"], res["del"], res["ins"]]}
    phase(38, f"the {res['n_utts']} held-out utterances: greedy phones (K4) PER {per:.4f} in {greedy_ms:.0f} ms "
              f"(launches {greedy_launches}); the CTC word loop (J={graph.n_states}, K4 then K2) WER {res['wer']:.4f} "
              f"(sub/del/ins {decode['sub_del_ins']}) in {graph_ms:.0f} ms against the untrained model's "
              f"{base['wer']:.4f} and the warm start's before its CTC steps {pre['wer']:.4f} (launches "
              f"{graph_launches}); on the widest batch B={Bw} T={Tw} K2's {k2_arms} arm with skips bitwise the plain "
              f"Viterbi, {k2_ms:.3f} ms (plain {k2_plain_ms:.1f} ms, bound {k2_b[0]:.4f} ms by {k2_b[1]}); K4 on the "
              f"encoder's layer 0 {k4['ms']:.3f} ms, {k4['device_ms']:.3f} ms with the host's part hidden (plain "
              f"{k4['plain_ms']:.1f} ms, bound {k4['bound_ms']:.4f} ms by {k4['bound_by']}, max |err| "
              f"{k4['max_abs_err']:.3g}); the whole layer, input GEMM + K4 {k4['layer_ms']:.3f} ms vs cuDNN nn.LSTM "
              f"{k4['library_ms']:.3f} ms on the packed batch (valid frames max |diff| "
              f"{k4['library_max_abs_diff']:.3g})")

    # ---- phase 39: stream --ctc's path: K4's carry arm, then K2's chunk arm with skips
    rows = min(CTC_STREAM_ROWS, fbw.size)
    feats, nfs = fbw.feats[:rows], fbw.n_frames[:rows]
    smodel = tn.LstmAmStream(V, D, hidden=NN_HIDDEN, layers=model.layers).to(dev)
    smodel.load_state_dict(model.state_dict())
    smodel.eval()
    graphs_s = pipe.decode_graphs(graph, rows, dev)[1]
    J = graph.n_states
    nfs_np = nfs.cpu().numpy()
    zero()
    carries = tn.lstm_stream_init(smodel, rows, dev)
    dec = online.OnlineDecoder(graphs_s, acoustic_scale=1.0)
    chunks = []
    with torch.no_grad():
        t0 = time.perf_counter()
        for off in range(0, Tw, ONLINE_TC):
            tc = min(ONLINE_TC, Tw - off)
            nv = np.clip(nfs_np - off, 0, tc).astype(np.int32)
            y, carries = smodel(feats[:, off:off + tc], carries, n_valid=torch.as_tensor(nv, device=dev))
            lp_c = torch.log_softmax(y, -1)
            chunks.append(lp_c)
            dec.process(lp_c, nv)
            dec.partial()
        path, entered, score = dec.finalize()
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    stream_launches = counts()
    only("the online CTC decode", stream_launches, ("lstm_scan", "lstm_scan_carry", "viterbi_chunk",
                                                    "viterbi_backtrace"))
    lp_s = torch.cat(chunks, 1)
    off_lp = ctc.make_ctc_scorer(model)(pipe.FeatBatch(fbw.utt_ids[:rows], feats, nfs, fbw.words[:rows]))
    sm = tn.valid_mask(nfs, Tw, dev)
    stream_err = float((lp_s - off_lp)[sm].abs().max())
    want = viterbi_cuda.viterbi(lp_s, graphs_s, nfs, acoustic_scale=1.0)
    live = nfs > 0
    if not (torch.equal(path, want.path) and torch.equal(entered, want.entered)
            and torch.equal(score[live], want.score[live])) or stream_err > STREAM_NN_ATOL:
        raise RuntimeError(f"the online CTC decode's finalize differs from offline K2 on the same posteriors, or the "
                           f"streamed posteriors are {stream_err:.3g} off the offline model's")
    d = torch.full((rows, J), online.NEG_INF, device=dev)
    s = torch.zeros(rows, dtype=torch.bool, device=dev)
    pd, ps = d.clone(), s.clone()
    bp, xa = viterbi_cuda.code_buffers(rows, J, ONLINE_CHECK_CHUNKS * ONLINE_TC, dev)
    for ci in range(ONLINE_CHECK_CHUNKS):
        off = ci * ONLINE_TC
        nv = torch.as_tensor(np.clip(nfs_np - off, 0, ONLINE_TC).astype(np.int32), device=dev)
        chunk = lp_s[:, off:off + ONLINE_TC]
        viterbi_cuda.chunk_step(d, s, chunk, nv, graphs_s, 1.0, 0.0, bp, xa, off)
        pd, ps, pbp, _pxa = online.chunk_step(pd, ps, chunk, nv, graphs_s, 1.0, 0.0)
        codes = viterbi_cuda.unpack_codes(bp, slice(off, off + ONLINE_TC), J)
        if not (torch.equal(d, pd) and torch.equal(s, ps) and torch.equal(codes, pbp)):
            raise RuntimeError(f"K2's chunk arm with skips differs from the plain chunk step at chunk {ci}")
    nv0 = torch.as_tensor(np.clip(nfs_np, 0, ONLINE_TC).astype(np.int32), device=dev)
    chunk0 = lp_s[:, :ONLINE_TC].contiguous()
    d0, s0 = torch.full((rows, J), online.NEG_INF, device=dev), torch.zeros(rows, dtype=torch.bool, device=dev)
    bpt, xat = viterbi_cuda.code_buffers(rows, J, ONLINE_TC, dev)
    chunk_b = k2_chunk_bound(graphs_s, nv0, s0, ONLINE_TC)
    chunk_plain_ms, _ = timed(lambda: online.chunk_step(d0, s0, chunk0, nv0, graphs_s, 1.0, 0.0), 2)
    chunk_ms, _ = timed(lambda: viterbi_cuda.chunk_step(d0, s0, chunk0, nv0, graphs_s, 1.0, 0.0, bpt, xat, 0), 20)
    stream = {"rows": rows, "chunks": len(chunks), "seconds": stream_s, "stream_vs_offline_max_abs_err": stream_err,
              "chunk_ms": chunk_ms, "chunk_plain_ms": chunk_plain_ms, "chunk_bound_ms": chunk_b[0],
              "chunk_bound_by": chunk_b[1], "shape": [rows, ONLINE_TC, J]}
    phase(39, f"stream --ctc's path on {rows} held-out streams of the widest batch ({len(chunks)} chunks of "
              f"{ONLINE_TC} frames, a partial after each): LstmAmStream on K4's carry arm then the online decoder on "
              f"K2's chunk arm with skips over the CTC word loop in {stream_s:.2f} s; finalize bitwise offline K2 on "
              f"the streamed posteriors (path, entered, score), those within {stream_err:.3g} of the offline model's "
              f"(limit {STREAM_NN_ATOL}); the chunk arm bitwise the plain chunk step on {ONLINE_CHECK_CHUNKS} chunks, "
              f"{chunk_ms:.4f} ms a chunk (plain {chunk_plain_ms:.2f} ms, bound {chunk_b[0]:.4f} ms by {chunk_b[1]}); "
              f"launches {stream_launches}")

    # ---- phase 40: BPE CTC and the three prefix beams
    texts = [w for f in merged for w in f.words]
    bpe = train_bpe(texts, n_merges=CTC_BPE_MERGES)
    bcfg_ = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=CTC_LR,
                        num_nn_steps=CTC_BPE_STEPS)
    zero()
    bpe_ms, (bmodel, _sd) = wall(lambda: pipe.train_ctc_bpe(merged, bpe, bcfg_, arch="lstm", steps=CTC_BPE_STEPS,
                                                            init_params=ce_model.state_dict()))
    bpe_launches = counts()
    only("BPE CTC training", bpe_launches, ("fb_forward", "fb_backward", "fb_combine"))
    max_units = max(len(bpe.encode(t)) for t in texts)
    sub = pipe.live_rows(held[0])
    sub = pipe.FeatBatch(sub.utt_ids[:CTC_BEAM_UTTS], sub.feats[:CTC_BEAM_UTTS], sub.n_frames[:CTC_BEAM_UTTS],
                         sub.words[:CTC_BEAM_UTTS])
    ulm = unit_ngram.estimate_unit_bigram([bpe.encode(t) for t in texts], bpe.n_units)
    biaser = biasing.biaser_from_bpe(bpe, [w[:2] for w in sub.words[:2]], weight=2.0)
    comp = biasing.CompiledBiaser(biaser, bpe.n_units)
    fusion = ctc.ctc_fusion_matrix(bpe.n_units, ulm, 0.5)
    ext = unit_ngram.compose_ext_scores([biaser.score, unit_ngram.fusion_score(ulm, 0.5)])
    rng = np.random.default_rng(40)
    peaked = torch.log_softmax(torch.as_tensor(6.0 * rng.standard_normal(
        (CTC_BEAM_UTTS, CTC_BEAM_FRAMES, bpe.n_units + 1)).astype(np.float32), device=dev), -1)
    cases = {"model": (ctc.make_ctc_scorer(bmodel)(sub), sub.n_frames),
             "peaked": (peaked, torch.full((CTC_BEAM_UTTS,), CTC_BEAM_FRAMES, dtype=torch.int32, device=dev))}
    beam = {}
    for name, (lp, nf) in cases.items():
        lp_host, nf_host = lp.cpu().numpy(), nf.cpu().numpy()
        dev_ms, got = wall(lambda: ctc.ctc_prefix_beam_decode_device(
            lp, nf, beam_size=CTC_BEAM, u_cap=int(lp.shape[1]), fusion=fusion, bias_next=comp.next_state,
            bias_delta=comp.delta))
        host_ms, want = wall(lambda: [ctc.ctc_prefix_beam_decode(lp_host[b, : nf_host[b]], CTC_BEAM, ext_score=ext)
                                      for b in range(len(nf_host))])
        plain_dev = ctc.ctc_prefix_beam_decode_device(lp, nf, beam_size=CTC_BEAM, u_cap=int(lp.shape[1]))
        plain_host = [ctc.ctc_prefix_beam_decode(lp_host[b, : nf_host[b]], CTC_BEAM) for b in range(len(nf_host))]
        native = [ctc.ctc_prefix_beam_decode_native(lp_host[b, : nf_host[b]], CTC_BEAM) for b in range(len(nf_host))]
        if any(r is None for r in native):
            raise RuntimeError("the native CTC beam (native/ctc_beam_native.cpp) did not build or load")
        same_lists = 0
        for label, a, b_, rtol in (("device vs host, fused and biased", got, want, CTC_BEAM_RTOL),
                                   ("device vs host", plain_dev, plain_host, CTC_BEAM_RTOL),
                                   ("native vs host", native, plain_host, 1e-9)):
            for ra, rb in zip(a, b_):
                full = [h for _s, h in ra] == [h for _s, h in rb] and np.allclose(
                    [s_ for s_, _h in ra], [s_ for s_, _h in rb], rtol=rtol, atol=0)
                same_lists += full
                # the whole ranked list on the short block and from the two float64 beams; the best
                # hypothesis on the model's utterances, where float32 may reorder the tail
                if not (full or (name == "model" and rtol > 1e-9 and ra[0][1] == rb[0][1])):
                    raise RuntimeError(f"prefix beams on the {name} posteriors, {label}: {ra[:2]} vs {rb[:2]}")
        n_frames_beam = int(nf.sum())
        beam[name] = {"device_ms": dev_ms, "host_ms": host_ms, "frames": n_frames_beam, "same_ranked_lists":
                      f"{same_lists} of {3 * len(nf_host)}",
                      "device_ms_per_frame": dev_ms / int(lp.shape[1]),
                      "hyp_units": sum(len(r[0][1]) for r in got if r)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lp_m, nf_m = cases["model"]
    with torch.profiler.profile(activities=acts) as prof:
        ctc.ctc_prefix_beam_decode_device(lp_m, nf_m, beam_size=CTC_BEAM, u_cap=int(lp_m.shape[1]), fusion=fusion,
                                          bias_next=comp.next_state, bias_delta=comp.delta)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    beam["launches_per_frame"] = sum(e.count for e in on_dev) / int(lp_m.shape[1])
    beam["device_busy_ms"] = sum(e.device_time_total for e in on_dev) / 1e3
    phase(40, f"BPE CTC: {CTC_BPE_MERGES} merges ({bpe.n_units} units, the longest training transcript "
              f"{max_units} units), {CTC_BPE_STEPS} steps in {bpe_ms:.0f} ms (launches {bpe_launches}); the "
              f"prefix beams (width {CTC_BEAM}) on {CTC_BEAM_UTTS} held-out utterances' posteriors and on peaked "
              f"random "
              f"ones ({CTC_BEAM_FRAMES} frames): device and host identical ranked hypotheses with fusion and biasing "
              f"and without (scores within rtol {CTC_BEAM_RTOL}; on the model's utterances the best hypothesis), "
              f"native identical to host; the device beam "
              + "; ".join(f"{k}: identical ranked lists {v['same_ranked_lists']}, {v['device_ms']:.0f} ms "
                          f"({v['device_ms_per_frame']:.2f} ms a frame; host dict beam {v['host_ms']:.0f} ms)"
                          for k, v in beam.items() if isinstance(v, dict))
              + f"; {beam['launches_per_frame']:.0f} device launches a frame, {beam['device_busy_ms']:.1f} ms busy "
              f"on the device (profiled)")

    # ---- phase 41: distillation and the MPC warm start
    dcfg_ = TrainConfig(nn_arch="lstm", nn_hidden=CTC_DISTILL_HIDDEN, nn_layers=NN_LAYERS, lr=CTC_LR,
                        num_nn_steps=CTC_DISTILL_STEPS)
    zero()
    dist_ms, (student, _sd) = wall(lambda: pipe.distill_ctc_units(merged, model, encode, lex.n_phones, dcfg_,
                                                                  student_arch="lstm", steps=CTC_DISTILL_STEPS))
    distill_launches = counts()
    only("distillation", distill_launches, ("fb_forward", "fb_backward", "fb_combine", "lstm_scan"))
    logs = []
    zero()
    mpc_ms, (_mpc, mpc_sd) = wall(lambda: pretrain_mpc(merged, dcfg_, arch="lstm", steps=CTC_INIT_STEPS))
    init_ms, (imodel, _sd) = wall(lambda: pipe.train_ctc(
        merged, lex, dcfg_, arch="lstm", steps=CTC_INIT_STEPS, init_params=mpc_sd,
        logger=types.SimpleNamespace(log=logs.append)))
    init_launches = counts()
    warm = [r for r in logs if r["stage"] == "ctc_warm_start"]
    if len(warm) != 1 or not 0 < warm[0]["leaves_copied"] < warm[0]["leaves_total"] or \
            not all(torch.isfinite(v).all() for v in list(student.state_dict().values())
                    + list(imodel.state_dict().values())):
        raise RuntimeError(f"distillation / --init-from: warm start {warm}")
    phase(41, f"distillation of a {CTC_DISTILL_HIDDEN}-hidden student from phase 37's model: {CTC_DISTILL_STEPS} "
              f"steps in {dist_ms:.0f} ms (the teacher on K4, the loss on K3; launches {distill_launches}); MPC "
              f"pretraining {CTC_INIT_STEPS} steps ({mpc_ms:.0f} ms) then CTC from it ({warm[0]['leaves_copied']} of "
              f"{warm[0]['leaves_total']} tensors copied) {CTC_INIT_STEPS} steps in {init_ms:.0f} ms (launches "
              f"{init_launches})")
    return {"paths": {"ctc_train": train_launches, "ctc_decode": {k: greedy_launches[k] + graph_launches[k]
                                                                  for k in graph_launches},
                      "ctc_stream": stream_launches, "ctc_bpe": bpe_launches, "ctc_distill": distill_launches,
                      "ctc_init": init_launches},
            "train": train, "decode": decode, "stream": stream, "beam": beam,
            "k3": {"arm": k3_arms[0], "shape": [Bl, Tl, Jl], "max_abs_err": k3_ll_err, "loss_rel_err": loss_err,
                   "grad_max_abs_err": grad_err, "grad_from_float64": grad64[True],
                   "plain_grad_from_float64": grad64[False], "ms": k3_dev, "plain_ms": k3_plain_ms,
                   "bounds": {k: v for k, v in k3_bounds.items()}, "loss_ms": loss_ms[True],
                   "loss_plain_ms": loss_ms[False], "library_loss_ms": lib_loss_ms},
            "k2": {"arm": k2_arms[0], "shape": [Bw, Tw, graph.n_states], "max_abs_err": 0.0, "ms": k2_ms,
                   "plain_ms": k2_plain_ms, "bound_ms": k2_b[0], "bound_by": k2_b[1]},
            "k4": k4,
            "model": model}


def ctc_cli_phase(dev: torch.device) -> dict:
    """Phase 42: the CTC paths of the CLI twins in this process (their
    output to build/chip_smoke_ctc_cli/out.txt), the launch counts set to 0
    before and read after: train_nn --objective ctc (phones, then
    --bpe-merges), train_lm --unit-ngram, decode --ctc (the word loop; --bpe
    with --bias and --fusion-lm), eval --ctc --bpe, stream --ctc (the word
    loop; --bpe with --bias and --fusion-lm), transcribe --ctc and search
    --ctc."""
    import contextlib
    import io
    import shutil

    from mogasr_torch.cli import decode as cli_decode
    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.cli import search as cli_search
    from mogasr_torch.cli import stream as cli_stream
    from mogasr_torch.cli import train_lm as cli_train_lm
    from mogasr_torch.cli import train_nn as cli_train_nn
    from mogasr_torch.cli import transcribe as cli_transcribe
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.am import lstm_cuda

    work = os.path.join(ROOT, "build", "chip_smoke_ctc_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    corpus = ["--synthetic", "16", "--synthetic-seed", "7"]
    on = ["--device", str(dev)]
    size = ["--nn-hidden", "128", "--nn-layers", "3"]
    ph, bp = os.path.join(work, "phones"), os.path.join(work, "bpe")
    phrases = os.path.join(work, "phrases.txt")
    with open(phrases, "w") as f:
        f.write("cat dog\nfish\n")
    beam = ["--bias", phrases, "--fusion-lm", os.path.join(work, "lm", "unit_lm.npz"), "--bias-beam", "4"]
    runs = [
        (cli_train_nn, corpus + ["--objective", "ctc", "--arch", "lstm", "--hidden", "128", "--layers", "3",
                                 "--steps", "4", "--run-dir", ph]),
        (cli_train_nn, corpus + ["--objective", "ctc", "--arch", "lstm", "--hidden", "128", "--layers", "3",
                                 "--steps", "4", "--bpe-merges", "30", "--run-dir", bp]),
        (cli_train_lm, corpus + ["--unit-ngram", "--bpe", os.path.join(bp, "bpe.json"), "--run-dir",
                                 os.path.join(work, "lm")]),
        (cli_decode, corpus + size + ["--ctc", "--am", "lstm", "--nn-ckpt", os.path.join(ph, "nn_ctc_lstm"),
                                      "--run-dir", os.path.join(work, "decode")]),
        (cli_decode, corpus + size + ["--ctc", "--am", "lstm", "--nn-ckpt", os.path.join(bp, "nn_ctc_lstm"), "--bpe",
                                      os.path.join(bp, "bpe.json"), "--run-dir", os.path.join(work, "decode_bpe")]
         + beam),
        (cli_eval, corpus + size + ["--ctc", "--nn-arch", "lstm", "--nn-ckpt", os.path.join(bp, "nn_ctc_lstm"),
                                    "--bpe", os.path.join(bp, "bpe.json"), "--run-dir", os.path.join(work, "eval")]),
        (cli_stream, ["--synthetic-demo", "--ctc", "--nn-ckpt", os.path.join(ph, "nn_ctc_lstm"), "--run-dir",
                      os.path.join(work, "stream")] + size),
        (cli_stream, ["--synthetic-demo", "--ctc", "--nn-ckpt", os.path.join(bp, "nn_ctc_lstm"), "--bpe",
                      os.path.join(bp, "bpe.json"), "--run-dir", os.path.join(work, "stream_bpe")] + size + beam),
        (cli_transcribe, ["--synthetic-demo", "--ctc", "--nn-arch", "lstm", "--nn-ckpt",
                          os.path.join(ph, "nn_ctc_lstm"), "--run-dir", os.path.join(work, "transcribe")] + size),
        (cli_search, corpus + size + ["--ctc", "--nn-arch", "lstm", "--nn-ckpt", os.path.join(ph, "nn_ctc_lstm"),
                                      "--terms", "cat,dog fish", "--run-dir", os.path.join(work, "search")]),
    ]
    zero_launches()
    viterbi_cuda.CHUNK_LAUNCHES = viterbi_cuda.BACKTRACE_LAUNCHES = lstm_cuda.CARRY_LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        for cli, argv in runs:
            cli.main(argv + on)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    launches.update(viterbi_chunk=viterbi_cuda.CHUNK_LAUNCHES, viterbi_backtrace=viterbi_cuda.BACKTRACE_LAUNCHES,
                    lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
    with open(os.path.join(work, "out.txt"), "w") as f:
        f.write(buf.getvalue())
    needed = ("viterbi", "fb_forward", "fb_backward", "fb_combine", "lstm_scan", "viterbi_chunk", "viterbi_backtrace",
              "lstm_scan_carry")
    if min(launches[k] for k in needed) == 0 or launches["gmm_score"]:
        raise RuntimeError(f"the CTC CLI twins did not go through every kernel of their path: {launches}")
    recs = {}
    for name in ("decode", "decode_bpe", "eval"):
        with open(os.path.join(work, name, "metrics.jsonl")) as f:
            recs[name] = json.loads(f.read().splitlines()[-1])
        if recs[name]["utts"] != 16 or not np.isfinite(recs[name]["wer"]):
            raise RuntimeError(f"{name}: {recs[name]}")
    finals = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith('{"final"')]
    if len(finals) != 2:
        raise RuntimeError(f"stream --ctc printed {len(finals)} final lines")
    phase(42, f"the CTC CLI twins in this process, {seconds:.1f} s: train_nn --objective ctc (phones; --bpe-merges "
              f"30), train_lm --unit-ngram --bpe, decode --ctc WER {recs['decode']['wer']:.4f}, decode --ctc --bpe "
              f"--bias --fusion-lm WER {recs['decode_bpe']['wer']:.4f}, eval --ctc --bpe WER "
              f"{recs['eval']['wer']:.4f} (4 steps: no limit), stream --ctc (the word loop; --bpe --bias "
              f"--fusion-lm), transcribe --ctc, search --ctc; launches {launches}")
    return launches



class ServeLoop:
    """Feeds (sid, wave) sessions through an engine as a server would: a
    session starts when a slot is free, each live session sends its next
    audio event of ``event`` samples with probability SERVE_FEED_P a tick
    (ragged arrival), ends when its audio is out and is finalized when
    drained; partials of every live session every ``partial_every`` ticks.
    Records a CUDA event after each tick (the device timeline's tick
    periods), the host ms of each partials() call, and, while
    ``count_syncs`` is set, the synchronizing CUDA calls inside tick()
    (``torch.cuda.set_sync_debug_mode``)."""

    def __init__(self, eng, sessions, event: int, seed: int, partial_every: int):
        self.eng, self.pending, self.waves = eng, list(sessions), dict(sessions)
        self.rng = np.random.default_rng(seed)
        self.event, self.partial_every = event, partial_every
        self.cursors, self.ended, self.finals = {}, set(), {}
        self.tick_events, self.partial_ms = [], []
        self.count_syncs, self.syncs, self.sync_ticks, self.sync_sites = False, 0, 0, {}

    def done(self) -> bool:
        return not self.pending and not self.cursors

    def step(self) -> None:
        import warnings

        eng = self.eng
        while self.pending and eng.n_live < eng.capacity:
            sid, _w = self.pending.pop(0)
            if not eng.start(sid):
                raise RuntimeError(f"the engine refused session {sid} with {eng.n_live} live")
            self.cursors[sid] = 0
        for sid, off in list(self.cursors.items()):
            if sid in self.ended:
                continue
            wave = self.waves[sid]
            if off >= len(wave):
                eng.end(sid)
                self.ended.add(sid)
            elif self.rng.random() < SERVE_FEED_P:
                eng.feed(sid, wave[off:off + self.event])
                self.cursors[sid] = off + self.event
        if self.count_syncs:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng.tick()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for w in caught:
                if "synchroniz" in str(w.message):
                    self.syncs += 1
                    site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
            self.sync_ticks += 1
        else:
            eng.tick()
        done_ev = torch.cuda.Event(enable_timing=True)
        done_ev.record()
        self.tick_events.append(done_ev)
        if eng.ticks % self.partial_every == 0:
            live = [sid for sid in self.cursors if eng.has(sid)]
            t0 = time.perf_counter()
            eng.partials(live)
            self.partial_ms.append(1e3 * (time.perf_counter() - t0))
        drained = [sid for sid in sorted(self.ended) if eng.drained(sid)]
        if drained:
            many = getattr(eng, "finalize_many", None)
            self.finals.update(many(drained) if many else {sid: eng.finalize(sid) for sid in drained})
            for sid in drained:
                self.ended.discard(sid)
                del self.cursors[sid]

    def tick_periods_ms(self) -> np.ndarray:
        """Device-timeline milliseconds between the ends of consecutive ticks."""
        torch.cuda.synchronize()
        return np.asarray([a.elapsed_time(b) for a, b in zip(self.tick_events, self.tick_events[1:])])


def serving_phases(dev, gmm, fcfg, dcfg, graph, held_out, ctc_model, sfu_exps_per_s) -> dict:
    """Phases 43-45: K2's ragged chunk arm at the serving shape; the GMM
    session engine at the serving configuration over the 768 held-out
    utterances, against the dedicated per-session pipeline; the CTC engine
    on phase 37's LstmAm. Returns each path's launch counts and the kernels
    line's serving entries."""
    import dataclasses

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda, lstm_cuda
    from mogasr_torch.am import neural as tn
    from mogasr_torch.am.ctc import CtcStreamDecoder
    from mogasr_torch.am.gmm import gmm_loglik
    from mogasr_torch.decoder import online, viterbi_cuda
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.hmm import graph as gr
    from mogasr_torch.serving.engine import BatchedCtcEngine, BatchedSessionEngine

    torch.set_grad_enabled(False)
    # the earlier phases' cached blocks go back to the card, so that the
    # engines' allocations are served without reclaiming (which waits for
    # the card)
    reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    torch.cuda.empty_cache()
    B, Tc, J = SERVE_CAPACITY, SERVE_TICK, graph.n_states
    S, K, D = gmm.means.shape
    scale = dcfg.acoustic_scale
    sfcfg = dataclasses.replace(fcfg, cmvn="sliding", cmvn_window=SERVE_CMVN_WINDOW)
    event = Tc * sfcfg.frame_shift    # 0.24 s: one tick's frames

    def zero():
        zero_launches()
        viterbi_cuda.CHUNK_LAUNCHES = viterbi_cuda.BACKTRACE_LAUNCHES = lstm_cuda.CARRY_LAUNCHES = 0

    def counts():
        c = launch_counts()
        c.update(viterbi_chunk=viterbi_cuda.CHUNK_LAUNCHES, viterbi_backtrace=viterbi_cuda.BACKTRACE_LAUNCHES,
                 lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
        return c

    def only(name, c, allowed):
        if any(v for k, v in c.items() if k not in allowed) or min(c[k] for k in allowed) == 0:
            raise RuntimeError(f"{name}: launches {c} (only and every one of {allowed})")

    # ---- phase 43: K2's chunk arm with a frame offset per row, at the serving shape
    graphs = pipe.decode_graphs(graph, B, dev)[1]
    rng = np.random.default_rng(SERVE_SEED)
    nv = rng.integers(1, Tc + 1, size=B).astype(np.int32)
    frame0 = rng.integers(0, SERVE_MAX_FRAMES - Tc, size=B)
    reused = rng.choice(np.arange(1, B), B // 8, replace=False)
    frame0[reused] = 0                                     # reused rows, back at frame 0
    nv[rng.choice(np.setdiff1d(np.arange(1, B), reused), B // 8, replace=False)] = 0   # idle rows
    frame0[0] = SERVE_MAX_FRAMES - nv[0]                   # a row filling its buffer to the end
    started_np = (rng.random(B) < 0.8) & (frame0 > 0)
    started0 = torch.as_tensor(started_np, device=dev)
    delta0 = torch.where(started0[:, None],
                         torch.as_tensor((rng.standard_normal((B, J)) * 10 - 300).astype(np.float32), device=dev),
                         torch.full((B, J), online.NEG_INF, device=dev))
    ll = torch.as_tensor((rng.standard_normal((B, Tc, S)) * 4 - 20).astype(np.float32), device=dev)
    bp0 = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, SERVE_MAX_FRAMES, -(-J // 32), 2), dtype=torch.int32, device=dev)
    xa0 = torch.randint(0, J, (B, SERVE_MAX_FRAMES), dtype=torch.int32, device=dev)
    nv_t = torch.as_tensor(nv)
    card = [t.clone() for t in (delta0, started0, bp0, xa0)]
    plain = [t.clone() for t in (delta0, started0, bp0, xa0)]
    viterbi_cuda.chunk_step(card[0], card[1], ll, nv_t, graphs, scale, 0.0, card[2], card[3], frame0)
    arms = sorted(set(viterbi_cuda.LAST_ARMS.tolist()))
    viterbi_cuda._plain_chunk_step(plain[0], plain[1], ll, nv_t.to(dev), graphs, scale, 0.0, plain[2], plain[3],
                                   frame0)
    same = [bool(torch.equal(a, b)) for a, b in zip(card, plain)]
    if not all(same) or arms != [viterbi_cuda.ARM_LOOP]:
        raise RuntimeError(f"K2's ragged chunk arm differs from the plain step scattered at the offsets (delta, "
                           f"started, codes, exit argmax equal: {same}; arms {arms})")
    written = int(sum(max(int(n) - (0 if s else 1), 0) for n, s in zip(nv, started_np)))
    del bp0, xa0, plain
    dt_, st_ = delta0.clone(), started0.clone()

    def ragged_call():
        viterbi_cuda.chunk_step(dt_, st_, ll, nv_t, graphs, scale, 0.0, card[2], card[3], frame0)

    ragged_call_ms, _ = timed(ragged_call, 20)   # the offsets' pinned copies and the host's part included
    ragged_ms = queued_ms(ragged_call)
    nv_dev = nv_t.to(dev)
    ragged_plain_ms, _ = timed(lambda: online.chunk_step(delta0.clone(), started0.clone(), ll, nv_dev, graphs,
                                                         scale, 0.0), 2)
    ragged_bound = k2_chunk_bound(graphs, nv_dev, started0, Tc)
    del card
    phase(43, f"({reserved_gib:.1f} GiB reserved by the caching allocator before, released) "
              f"K2's chunk arm with a frame offset per row at the serving shape (B={B}, Tc={Tc}, J={J}, buffers "
              f"of {SERVE_MAX_FRAMES} frames from random bits; offsets {int(frame0.min())}..{int(frame0.max())}, "
              f"{len(reused)} reused rows at 0, {int((nv == 0).sum())} idle rows, one filling its buffer to the end, "
              f"{int(started_np.sum())} rows started before; {int(nv.sum())} valid frames): delta, started, the "
              f"{written} frames' codes and exit argmax and every other frame's bits bitwise the plain chunk step "
              f"scattered at the offsets; word-loop arm; {ragged_ms:.4f} ms a call on the device with the host's "
              f"part hidden, {ragged_call_ms:.4f} ms a call alone (plain {ragged_plain_ms:.3f} ms, bound "
              f"{ragged_bound[0]:.4f} ms by {ragged_bound[1]})")
    ragged = {"shape": [B, Tc, J], "valid_frames": int(nv.sum()), "ms": ragged_ms, "call_ms": ragged_call_ms,
              "plain_ms": ragged_plain_ms, "bound_ms": ragged_bound[0], "bound_by": ragged_bound[1],
              "max_abs_err": 0.0}

    # ---- phase 44: the GMM session engine at the serving configuration
    p32 = gmm_cuda.kernel_params(gmm, "float32")

    def score_fn(feats):
        return pipe.score_batch(feats, gmm, params=p32)

    sessions = [(u.utt_id, u.wave) for u in held_out]
    gate = [sid for sid, _w in sessions[:SERVE_GATE]]
    refs = {u.utt_id: [w.lower() for w in u.words] for u in held_out}
    audio_s = sum(len(w) for _sid, w in sessions) / sfcfg.sample_rate

    def wer_of(finals):
        return corpus_wer([refs[sid] for sid, _w in sessions],
                          [[w.lower() for w in finals[sid][0]] for sid, _w in sessions])[0]

    def gmm_engine(history, feature_path):
        return BatchedSessionEngine(graph, score_fn, sfcfg, dcfg, capacity=B, tick_frames=Tc, history=history,
                                    max_frames=SERVE_MAX_FRAMES, feature_path=feature_path, device=dev)

    def run(eng, windows=False):
        """Every session through eng; with windows, a sync-counting window
        and then a profiled window of SERVE_PROFILE_TICKS ticks each."""
        import gc

        drv = ServeLoop(eng, sessions, event, SERVE_SEED, SERVE_PARTIAL_EVERY)
        prof = None
        zero()
        t0 = time.perf_counter()
        while not drv.done():
            if windows and not drv.sync_ticks and eng.ticks == SERVE_WINDOW_AT:
                gc.collect()
                drv.count_syncs = True
                for _ in range(SERVE_PROFILE_TICKS):
                    drv.step()
                drv.count_syncs = False
                try:
                    prof = device_profile(lambda: [drv.step() for _ in range(SERVE_PROFILE_TICKS)], top=1000)[:3]
                except RuntimeError:   # a window without device activity: reported as not measured
                    prof = None
                break  # the windows are all this run is for
            drv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return drv, wall, counts(), prof

    graphs1 = vit.graphs_to_torch(gr.batch_graphs([graph]), dev)

    def dedicated(wave):
        fe = StreamingFrontend(sfcfg, device=dev)
        dec = online.OnlineDecoder(graphs1, acoustic_scale=scale)
        for f in [fe.process(wave[i:i + event]) for i in range(0, len(wave), event)] + [fe.finalize()]:
            if f.size:
                dec.process(score_fn(torch.as_tensor(f[None], device=dev)), np.asarray([f.shape[0]]))
        path, entered, _score = dec.finalize()
        return gr.path_words(graph, path[0].cpu().numpy(), entered[0].cpu().numpy())

    t0 = time.perf_counter()
    want = {sid: dedicated(w) for sid, w in sessions[:SERVE_GATE]}
    ded_s = time.perf_counter() - t0
    exact, _w, exact_launches, _ = run(gmm_engine("device", "host"))
    only("the GMM engine (device history, host features)", exact_launches,
         ("gmm_score", "viterbi_chunk", "viterbi_backtrace"))
    fast, fast_wall, fast_launches, _ = run(gmm_engine("device", "device"))
    only("the GMM engine (device history, device features)", fast_launches,
         ("gmm_score", "viterbi_chunk", "viterbi_backtrace"))
    hostb, host_wall, host_launches, _ = run(gmm_engine("host", "host"))
    only("the GMM engine (host history, host features)", host_launches, ("gmm_score", "viterbi_chunk"))
    windowed, _w, _c, prof = run(gmm_engine("device", "device"), windows=True)
    bad = {name: [sid for sid in gate if d.finals[sid][0] != want[sid]] for name, d in
           (("device history, host features", exact), ("device history, device features", fast))}
    if any(bad.values()):
        raise RuntimeError(f"engine finals differ from the dedicated per-session pipeline's: {bad}")
    host_diff = [sid for sid, _w in sessions if hostb.finals[sid][0] != exact.finals[sid][0]]
    if host_diff:
        raise RuntimeError(f"the host-history engine's finals differ from the device history's on {host_diff[:8]}")
    n_fast_diff = sum(fast.finals[sid][0] != exact.finals[sid][0] for sid, _w in sessions)
    periods = fast.tick_periods_ms()
    ticks = fast.eng.ticks
    per_tick = {k: v / ticks for k, v in fast_launches.items() if v}
    wer = {"exact": wer_of(exact.finals), "device": wer_of(fast.finals), "host": wer_of(hostb.finals)}
    frames = fast.eng.frames_decoded
    if prof is not None:
        wall_ms, dev_ms, events = prof
        by_name = [(name[:48], n / SERVE_PROFILE_TICKS, ms / SERVE_PROFILE_TICKS) for name, ms, n in events]
        n_launch = sum(r[1] for r in by_name)
        prof_text = (f"a profiled window of {SERVE_PROFILE_TICKS} ticks: {wall_ms:.1f} ms wall, {dev_ms:.1f} ms on the "
                     f"device ({100 * dev_ms / wall_ms:.1f}% busy), {n_launch:.1f} device launches a tick, by kernel "
                     f"a tick: " + "; ".join(f"{n} x{c:.2f} {m:.3f} ms" for n, c, m in by_name[:14]))
    else:
        n_launch = dev_ms = wall_ms = None
        prof_text = "the profiled window recorded no device activity: busy share and launches by kernel not measured"
    # K1 float32/sum at the tick's 1536 frames, on real features
    fe = StreamingFrontend(sfcfg, device=dev)
    rows = np.concatenate([fe.process(np.concatenate([w for _s, w in sessions[:16]])), fe.finalize()])[:B * Tc]
    x = torch.as_tensor(rows, device=dev)
    k1_ms = queued_ms(lambda: gmm_cuda.gmm_loglik_fused(x, gmm, "float32", "sum", params=p32))
    k1_call_ms, k1_out = timed(lambda: gmm_cuda.gmm_loglik_fused(x, gmm, "float32", "sum", params=p32), 20)
    k1_plain_ms, k1_want = timed(lambda: gmm_loglik(x, gmm, mode="sum", compute_dtype="float32"), 3)
    k1_err = float((k1_out - k1_want).abs().max())
    if not torch.allclose(k1_out, k1_want, atol=K1_ATOL, rtol=K1_RTOL):
        raise RuntimeError(f"K1 f32/sum at the tick's {x.shape[0]} frames off plain by {k1_err}")
    k1_b = k1_bound(x.shape[0], S, K, D, "float32", "sum", sfu_exps_per_s)
    serve = {"capacity": B, "tick_frames": Tc, "sessions": len(sessions), "audio_s": audio_s, "ticks": ticks,
             "frames": frames, "wall_s": fast_wall, "streams_per_card": audio_s / fast_wall,
             "tick_ms_median": float(np.median(periods)), "tick_ms_p90": float(np.percentile(periods, 90)),
             "partial_ms_median": float(np.median(fast.partial_ms)), "partial_ms_p90":
             float(np.percentile(fast.partial_ms, 90)), "launches_per_tick": per_tick,
             "device_launches_per_tick": n_launch, "syncs_per_tick": windowed.syncs / windowed.sync_ticks,
             "sync_sites": windowed.sync_sites,
             "busy_share": dev_ms / wall_ms if prof is not None else None, "wer": wer, "host_history_wall_s": host_wall,
             "host_history_streams_per_card": audio_s / host_wall, "dedicated_s": ded_s,
             "device_path_finals_differing": n_fast_diff}
    phase(44, f"the GMM session engine at the serving configuration (capacity {B}, {Tc}-frame ticks, sliding CMVN "
              f"over {SERVE_CMVN_WINDOW} frames, J={J}, K1 float32/sum; the {len(sessions)} held-out utterances in "
              f"0.24 s events, each sent with probability {SERVE_FEED_P:g} a tick, slots reused; partials every "
              f"{SERVE_PARTIAL_EVERY} ticks): finals equal to the dedicated per-session pipeline's on the first "
              f"{len(gate)} sessions ({ded_s:.1f} s) with device history and host features, and with device history "
              f"and device features; host history equal to device history on all {len(sessions)}; the device feature "
              f"path differs from the host path on {n_fast_diff} of {len(sessions)}; WER {wer['device']:.4f} (device "
              f"features), {wer['exact']:.4f} (host features). Device history, device features: {ticks} ticks, "
              f"{frames} frames, {audio_s:.1f} s of audio in {fast_wall:.2f} s: {audio_s / fast_wall:.1f} realtime "
              f"streams a card; a tick {np.median(periods):.2f} ms median on the device timeline (p90 "
              f"{np.percentile(periods, 90):.2f}); partials of {B} sessions {np.median(fast.partial_ms):.2f} ms "
              f"median (p90 {np.percentile(fast.partial_ms, 90):.2f}); launches a tick "
              + ", ".join(f"{k} {v:.2f}" for k, v in per_tick.items())
              + f"; {windowed.syncs} synchronizing calls in {windowed.sync_ticks} ticks {windowed.sync_sites}; "
              + prof_text + f". Host history, host features: {audio_s / host_wall:.1f} streams a card ({host_wall:.2f} s). "
              f"K1 f32/sum at a tick's {x.shape[0]} frames {k1_ms:.4f} ms a call with the host's part hidden, "
              f"{k1_call_ms:.4f} ms alone "
              f"(plain {k1_plain_ms:.3f} ms, bound "
              f"{k1_b[0]:.4f} ms by {k1_b[1]}, max |err| {k1_err:.3g})")
    k1_tick = {"n": int(x.shape[0]), "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_b[0], "bound_by": k1_b[1],
               "max_abs_err": k1_err}
    del fast, exact, hostb, windowed

    # ---- phase 45: the CTC session engine on phase 37's LstmAm
    V, H = ctc_model.n_pdfs, ctc_model.hidden
    smodel = tn.LstmAmStream(V, D, hidden=H, layers=ctc_model.layers).to(dev)
    smodel.load_state_dict(ctc_model.state_dict())
    smodel.eval()
    ctc_sessions = sessions[:SERVE_CTC_UTTS]

    def ctc_engine(feature_path):
        return BatchedCtcEngine(smodel, lambda: CtcStreamDecoder(blank_id=V - 1), sfcfg, capacity=B, tick_frames=Tc,
                                feature_path=feature_path, device=dev)

    def ctc_dedicated(wave):
        fe = StreamingFrontend(sfcfg, device=dev)
        dec = CtcStreamDecoder(blank_id=V - 1)
        carries = tn.lstm_stream_init(smodel, 1, dev)
        for f in [fe.process(wave[i:i + event]) for i in range(0, len(wave), event)] + [fe.finalize()]:
            if f.size:
                logits, carries = smodel(torch.as_tensor(f[None], device=dev), carries)
                dec.step(torch.log_softmax(logits, dim=-1)[0])
        return list(dec.finalize())

    def ctc_run(feature_path, subset, windows=False):
        drv = ServeLoop(ctc_engine(feature_path), subset, event, SERVE_SEED, SERVE_PARTIAL_EVERY)
        zero()
        t0 = time.perf_counter()
        while not drv.done():
            if windows and not drv.sync_ticks and drv.eng.ticks == SERVE_WINDOW_AT:
                drv.count_syncs = True
                for _ in range(SERVE_PROFILE_TICKS):
                    drv.step()
                drv.count_syncs = False
            else:
                drv.step()
        torch.cuda.synchronize()
        return drv, time.perf_counter() - t0, counts()

    ctc_want = {sid: ctc_dedicated(w) for sid, w in ctc_sessions[:SERVE_GATE]}
    ctc_exact, _w, c_exact = ctc_run("host", ctc_sessions[:SERVE_GATE])
    ctc_fast, ctc_wall, c_fast = ctc_run("device", ctc_sessions, windows=True)
    for name, c in (("the CTC engine (host features)", c_exact), ("the CTC engine (device features)", c_fast)):
        only(name, c, ("lstm_scan", "lstm_scan_carry"))
    bad = [sid for sid in ctc_want if ctc_exact.finals[sid][0] != ctc_want[sid]]
    if bad:
        raise RuntimeError(f"the CTC engine's units differ from the dedicated stream's on {bad[:8]}")
    n_units = sum(len(u) for u in ctc_want.values())
    ctc_agree = sum(ctc_fast.finals[sid][0] == ctc_want[sid] for sid in ctc_want)
    ctc_periods = ctc_fast.tick_periods_ms()
    ctc_audio = sum(len(w) for _s, w in ctc_sessions) / sfcfg.sample_rate
    ctc_per_tick = {k: v / ctc_fast.eng.ticks for k, v in c_fast.items() if v}
    # K4's carry arm at the tick's shape: layer 0 of the engine's model, idle rows at 0
    feats = torch.as_tensor(np.pad(rows, ((0, B * Tc - rows.shape[0]), (0, 0))).reshape(B, Tc, D), device=dev)
    h0, c0 = (torch.as_tensor(rng.standard_normal((B, H)).astype(np.float32), device=dev) for _ in range(2))
    k4_tick = k4_layer_times(smodel.cells[0], feats, torch.as_tensor(nv, device=dev), h0=h0, c0=c0, reps=20)
    phase(45, f"the CTC session engine (capacity {B}, {Tc}-frame ticks) on phase 37's LstmAm ({ctc_model.layers} x "
              f"{H}, {V} outputs), K4's carry arm: units equal to the dedicated per-session CTC stream's on the first "
              f"{len(ctc_want)} sessions ({n_units} units) with host features; device features on "
              f"{len(ctc_sessions)} sessions: {ctc_agree} of {len(ctc_want)} equal to the dedicated stream's, "
              f"{ctc_audio:.1f} s of audio in {ctc_wall:.2f} s: {ctc_audio / ctc_wall:.1f} realtime streams a card, a "
              f"tick {np.median(ctc_periods):.2f} ms median on the device timeline, partials "
              f"{np.median(ctc_fast.partial_ms):.2f} ms median, launches a tick "
              + ", ".join(f"{k} {v:.2f}" for k, v in ctc_per_tick.items())
              + f", {ctc_fast.syncs} synchronizing calls in {ctc_fast.sync_ticks} ticks {ctc_fast.sync_sites}; K4's "
              f"carry arm at B={B}, "
              f"Tc={Tc}, H={H} with {k4_tick['idle_rows']} idle rows (their carries bitwise) {k4_tick['ms']:.4f} ms "
              f"a call, {k4_tick['device_ms']:.4f} ms with the host's part hidden (plain "
              f"{k4_tick['plain_ms']:.3f} ms, bound {k4_tick['bound_ms']:.4f} ms by {k4_tick['bound_by']}, max |err| "
              f"{k4_tick['max_abs_err']:.3g}); the whole layer, input GEMM + K4 {k4_tick['layer_ms']:.4f} ms vs cuDNN "
              f"nn.LSTM with (h0, c0) {k4_tick['library_ms']:.4f} ms (valid frames max |diff| "
              f"{k4_tick['library_max_abs_diff']:.3g})")
    ctc = {"sessions": len(ctc_sessions), "audio_s": ctc_audio, "wall_s": ctc_wall,
           "streams_per_card": ctc_audio / ctc_wall, "tick_ms_median": float(np.median(ctc_periods)),
           "partial_ms_median": float(np.median(ctc_fast.partial_ms)), "launches_per_tick": ctc_per_tick,
           "syncs_per_tick": ctc_fast.syncs / max(ctc_fast.sync_ticks, 1), "device_feature_agreement": ctc_agree}
    return {"paths": {"serve_gmm": fast_launches, "serve_gmm_exact": exact_launches, "serve_gmm_host": host_launches,
                      "serve_ctc": c_fast, "serve_ctc_exact": c_exact},
            "ragged": ragged, "gmm": serve, "ctc": ctc, "k1_tick": k1_tick, "k4_tick": k4_tick}


def serve_cli_phase(dev: torch.device) -> dict:
    """Phase 46: the serve twin in this process over one stdin event file (its
    output to build/chip_smoke_serve_cli/out.txt), the launch counts set to 0
    before and read after: the GMM per-session mode against --engine (host
    and device features), --ctc (phase 42's BPE model) per-session against
    --engine, and one --tcp round trip of two sessions."""
    import contextlib
    import io
    import shutil
    import socket
    import threading

    from mogasr_torch.am import lstm_cuda
    from mogasr_torch.cli import serve as cli_serve
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.decoder import viterbi_cuda

    work = os.path.join(ROOT, "build", "chip_smoke_serve_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    utts = make_corpus(SERVE_CLI_SESSIONS, words_per_utt=(2, 4), seed=46)
    event = SERVE_TICK * 160
    lines = [{"type": "start", "session": u.utt_id} for u in utts]
    chunks = {u.utt_id: [u.wave[i:i + event] for i in range(0, len(u.wave), event)] for u in utts}
    for i in range(max(len(c) for c in chunks.values())):
        lines += [{"type": "audio", "session": sid, "pcm": c[i].tolist()} for sid, c in chunks.items() if i < len(c)]
    lines += [{"type": "end", "session": u.utt_id} for u in utts]
    text = "\n".join(json.dumps(line) for line in lines + [{"type": "shutdown"}]) + "\n"
    bp = os.path.join(ROOT, "build", "chip_smoke_ctc_cli", "bpe")
    ctc = ["--ctc", "--nn-ckpt", os.path.join(bp, "nn_ctc_lstm"), "--bpe", os.path.join(bp, "bpe.json"),
           "--nn-hidden", "128", "--nn-layers", "3"]
    engine = ["--engine", "--engine-capacity", str(SERVE_CLI_SESSIONS)]
    runs = {"gmm": [], "gmm_engine_host": engine + ["--feature-path", "host"], "gmm_engine": engine,
            "ctc": ctc, "ctc_engine_host": ctc + engine + ["--feature-path", "host"], "ctc_engine": ctc + engine}
    finals, out = {}, io.StringIO()
    real_stdin = sys.stdin
    zero_launches()
    viterbi_cuda.CHUNK_LAUNCHES = viterbi_cuda.BACKTRACE_LAUNCHES = lstm_cuda.CARRY_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        for name, argv in runs.items():
            buf = io.StringIO()
            sys.stdin = io.StringIO(text)
            with contextlib.redirect_stdout(buf):
                cli_serve.main(argv + ["--device", str(dev), "--run-dir", os.path.join(work, name)])
            evs = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
            finals[name] = {e["session"]: e["final"] for e in evs if "final" in e}
            out.write(f"# {name}\n{buf.getvalue()}")
    finally:
        sys.stdin = real_stdin
    seconds = time.perf_counter() - t0
    # one --tcp round trip: two sessions from one connection, then shutdown
    port_file = os.path.join(work, "port.txt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        server = threading.Thread(target=cli_serve.main, args=(
            ["--tcp", "0", "--port-file", port_file, "--device", str(dev), "--run-dir", os.path.join(work, "tcp")],),
            daemon=True)
        server.start()
        for _ in range(1200):
            if os.path.exists(port_file) and open(port_file).read():
                break
            time.sleep(0.05)
        two = [u.utt_id for u in utts[:2]]
        with socket.create_connection(("127.0.0.1", int(open(port_file).read())), timeout=120) as conn:
            conn.sendall("".join(json.dumps(e) + "\n" for e in lines if e.get("session") in two).encode())
            got, rest = {}, b""
            while len(got) < 2:
                data = conn.recv(1 << 16)
                if not data:
                    break
                rest += data
                while b"\n" in rest:
                    line, rest = rest.split(b"\n", 1)
                    e = json.loads(line)
                    if "final" in e:
                        got[e["session"]] = e["final"]
            conn.sendall(b'{"type": "shutdown"}\n')
        server.join(timeout=120)
    out.write(f"# tcp\n{buf.getvalue()}")
    launches = launch_counts()
    launches.update(viterbi_chunk=viterbi_cuda.CHUNK_LAUNCHES, viterbi_backtrace=viterbi_cuda.BACKTRACE_LAUNCHES,
                    lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
    with open(os.path.join(work, "out.txt"), "w") as f:
        f.write(out.getvalue())
    needed = ("gmm_score", "viterbi_chunk", "viterbi_backtrace", "lstm_scan", "lstm_scan_carry")
    if min(launches[k] for k in needed) == 0 or launches["viterbi"]:
        raise RuntimeError(f"the serve twin did not go through every kernel of its paths: {launches}")
    sids = {u.utt_id for u in utts}
    for name, f in finals.items():
        if set(f) != sids:
            raise RuntimeError(f"serve {name}: finals for {sorted(f)}, not the {len(sids)} sessions")
    for mode in ("gmm", "ctc"):
        if finals[f"{mode}_engine_host"] != finals[mode]:
            raise RuntimeError(f"serve --engine ({mode}, host features) finals differ from the per-session mode's")
    if server.is_alive() or got != {sid: finals["gmm"][sid] for sid in two}:
        raise RuntimeError(f"the --tcp round trip: finals {got}, server alive {server.is_alive()}")
    agree = {mode: sum(finals[f"{mode}_engine"][s] == finals[mode][s] for s in sids) for mode in ("gmm", "ctc")}
    phase(46, f"the serve twin in this process, {seconds:.1f} s for six runs over one stdin file of "
              f"{SERVE_CLI_SESSIONS} interleaved sessions ({len(lines)} events): --engine finals equal to the "
              f"per-session mode's with host features (GMM and --ctc --bpe); with device features "
              f"{agree['gmm']} and {agree['ctc']} of {len(sids)} equal; --tcp: two sessions from one connection, "
              f"the per-session finals, shutdown; launches {launches}")
    return launches


def rnnt_dp_cells(blank, emit, n_frames, n_labels):
    """The transducer DP a cell at a time (plain ops on the card, one
    logaddexp a cell): the form the anti-diagonal DP replaces, timed beside
    it."""
    B, T, U1 = blank.shape
    out = []
    for b in range(B):
        nf, nl = max(int(n_frames[b]), 1), int(n_labels[b])
        alpha = [[None] * (nl + 1) for _ in range(nf)]
        for t in range(nf):
            for u in range(nl + 1):
                if t == 0 and u == 0:
                    a = blank.new_zeros(())
                elif t == 0:
                    a = alpha[0][u - 1] + emit[b, 0, u - 1]
                elif u == 0:
                    a = alpha[t - 1][0] + blank[b, t - 1, 0]
                else:
                    a = torch.logaddexp(alpha[t - 1][u] + blank[b, t - 1, u], alpha[t][u - 1] + emit[b, t, u - 1])
                alpha[t][u] = a
        out.append(-(alpha[nf - 1][nl] + blank[b, nf - 1, nl]))
    return torch.stack(out)


def rnnt_tie_gap(model, feats, n_frames: int, want, got, max_symbols_per_frame: int = 4) -> float:
    """The host greedy's decisions replayed on one utterance's features
    ([T, D]): the least top-2 joint logit gap over the decisions after its
    last emission in common with ``got`` up to its first differing one
    (``want`` is the path's own tokens): where a float-order change could
    have turned the path into ``got``."""
    from mogasr_torch.am import rnnt as R

    k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), min(len(want), len(got)))
    enc = R.rnnt_encode(model, feats[None, :n_frames], torch.as_tensor([n_frames], device=feats.device))[0]
    fns = R.make_rnnt_decoder_fns(model)
    hist = np.full((1, k + 2), -1, np.int32)
    pred, n_hyp, gaps = fns.pred_of(hist, [0]), 0, []
    for t in range(n_frames):
        for _ in range(max_symbols_per_frame):
            top = torch.topk(fns.joint_of(enc[t:t + 1], pred)[0], 2)
            if n_hyp >= k:
                gaps.append(float(top.values[0] - top.values[1]))
            best = int(top.indices[0])
            if best == fns.blank:
                break
            if n_hyp == k:
                return min(gaps)
            hist[0, n_hyp] = best
            n_hyp += 1
            pred = fns.pred_of(hist, [n_hyp])
    return min(gaps) if gaps else float("inf")


def rnnt_phases(dev: torch.device, topo, fcfg, corpus, bcfg, train_fbs, ce_model) -> dict:
    """Phases 47-53: the transducer loss on the card against the float64
    DP and the aux CTC term on K3; RNN-T training at full width; the
    held-out decodes (K4 on the encoder; host greedy, label loop and frame
    scan equal; the device beam against the batched host beam); pruned and
    MWER steps; the stream on K4's carry arm; BatchedRnntEngine at the
    serving configuration; the neural LMs on K4. Returns each path's launch
    counts and the kernels line's sub-entries."""
    import copy
    import dataclasses

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import ctc, lstm_cuda
    from mogasr_torch.am import rnnt as R
    from mogasr_torch.am import rnnt_pruned as RP
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.pretrain import transfer_pretrained
    from mogasr_torch.config import TrainConfig
    from mogasr_torch.eval.wer import corpus_wer, edit_counts
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.lm import neural as NL
    from mogasr_torch.serving.engine import BatchedRnntEngine

    torch.cuda.empty_cache()
    lex = topo.lexicon
    V, D = lex.n_phones, fcfg.feat_dim

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def zero():
        zero_launches()
        lstm_cuda.CARRY_LAUNCHES = 0

    def counts():
        c = launch_counts()
        c.update(lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
        return c

    def only(name, c, allowed):
        if any(v for k, v in c.items() if k not in allowed) or min(c[k] for k in allowed) == 0:
            raise RuntimeError(f"{name}: launches {c} (only and every one of {allowed})")

    def encode(words):
        return ctc.ctc_labels_from_words(lex, words)

    merged = ctc_batches(train_fbs)
    labeled = pipe._pack_ctc_targets(merged, encode)
    cfg = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=RNNT_LR,
                      num_nn_steps=RNNT_SCHEDULE)
    untrained = pipe.rnnt_model_for(V, cfg, merged)
    model = copy.deepcopy(untrained)
    ce_enc = {f"encoder.{k}": v for k, v in ce_model.state_dict().items()}
    warm_sd, copied, total = transfer_pretrained(ce_enc, model.state_dict())
    model.load_state_dict(warm_sd)

    # ---- phase 47: the loss on the card against the float64 DP; the aux CTC term on K3
    fb, labels, nl = labeled[0]
    rows = torch.arange(RNNT_CHECK, device=dev)
    nf_c, lab_c, nl_c = fb.n_frames[rows].clone(), labels[rows].clone(), nl[rows].clone()
    nf_c[1] = 1                      # one frame
    nl_c[2] = 0                      # no labels
    lab_c[2] = -1
    nf_c[3] = 0                      # no frames: scored on frame 0
    with torch.no_grad():
        logits = model(fb.feats[rows], fb.n_frames[rows], lab_c, use_kernels=True)
    x = logits.clone().requires_grad_()
    with torch.enable_grad():
        nll = R.rnnt_loss(x, nf_c, lab_c, nl_c)
        nll.sum().backward()
    Bc, Tc_, U1c = logits.shape[:3]

    def grids(z):
        """(blank, emit) log-probabilities of the joint's outputs, in z's dtype."""
        lp = torch.log_softmax(z, -1)
        emit = torch.gather(lp[:, :, :-1, :], 3, lab_c.clamp(min=0).to(z.device)[:, None, :, None].expand(
            Bc, Tc_, U1c - 1, 1))[..., 0]
        return lp[..., V], emit

    # the gradient of the DP in float64 (rnnt_loss computes in float32, as the
    # reference's does), and float32's own distance from it: rnnt_loss on the CPU
    grads = {}
    for dtype in (torch.float64, torch.float32):
        xc = logits.to(device="cpu", dtype=dtype, copy=True).requires_grad_()
        with torch.enable_grad():
            out = (R.rnnt_dp_nll(*grids(xc), nf_c.cpu(), nl_c.cpu()) if dtype == torch.float64
                   else R.rnnt_loss(xc, nf_c.cpu(), lab_c.cpu(), nl_c.cpu()))
            out.sum().backward()
        grads[dtype] = xc.grad.double()
    lp64 = torch.log_softmax(logits.double().cpu(), -1).numpy()
    oracle = np.asarray([R.rnnt_loss_np(lp64[b, : max(int(nf_c[b]), 1)], lab_c[b, : int(nl_c[b])].tolist())
                         for b in range(RNNT_CHECK)])
    loss_err = float(np.max(np.abs(nll.detach().cpu().numpy() - oracle) / np.abs(oracle)))
    grad_err = float((x.grad.double().cpu() - grads[torch.float64]).abs().max())
    cpu32_err = float((grads[torch.float32] - grads[torch.float64]).abs().max())
    grad_limit = min(max(RNNT_GRAD_RATIO * cpu32_err, FB_ERR_FLOOR), FB_POST64_ATOL)
    if loss_err > RNNT_LOSS_RTOL or grad_err > grad_limit:
        raise RuntimeError(f"the transducer loss on the card: {loss_err} relative to the float64 DP (limit "
                           f"{RNNT_LOSS_RTOL}), gradient {grad_err} from the float64 DP's (the CPU's float32 "
                           f"{cpu32_err}; limit {grad_limit})")
    with torch.no_grad():
        blank_c, emit_c = grids(logits)
        small = (blank_c[:4, :80, :16].contiguous(), emit_c[:4, :80, :15].contiguous(), nf_c[:4].clamp(max=80),
                 nl_c[:4].clamp(max=15))
        diag_small_ms, d_small = timed(lambda: R.rnnt_dp_nll(*small), 3)
        cells_ms, c_small = timed(lambda: rnnt_dp_cells(*small), 1)
    cells_err = float((d_small - c_small).abs().max())
    if cells_err > 1e-3:
        raise RuntimeError(f"the anti-diagonal DP against the cell-at-a-time form: {cells_err}")
    Bf, Tf = fb.feats.shape[:2]
    with torch.no_grad():
        enc = model.encode(fb.feats, fb.n_frames, use_kernels=True)
        full_logits = model.joint(enc, model.prediction(labels))

    def loss_and_backward():
        xf = full_logits.clone().requires_grad_()
        with torch.enable_grad():
            R.rnnt_loss(xf, fb.n_frames, labels, nl).sum().backward()
        return xf.grad

    zero()
    full_ms, _ = wall(loss_and_backward)
    full_ms, _ = wall(loss_and_backward)
    dp_launches = counts()
    # device launches of the DP's loss and backward, a frame and an anti-diagonal
    Ul = labels.shape[1]
    try:
        dp_events = device_profile(loss_and_backward, names=("",))[3][""][1]
    except RuntimeError:
        dp_events = None   # a profiled window without device activity: not measured
    if any(dp_launches.values()):
        raise RuntimeError(f"the transducer loss launched kernels: {dp_launches}")
    del full_logits
    with torch.no_grad():
        ctc_logits = model.ctc_head(enc)
    aux = {}
    for use_kernels in (True, False):
        xc = ctc_logits.clone().requires_grad_()

        def aux_loss():
            with torch.enable_grad():
                out = ctc.ctc_loss(xc, fb.n_frames, labels, nl, use_kernels=use_kernels)
                out.sum().backward()
            return out.detach()

        ms, l_ = wall(aux_loss)
        aux[use_kernels] = (l_, xc.grad, ms)
    aux_err = float(((aux[True][0] - aux[False][0]).abs() / aux[False][0].abs()).max())
    aux_grad = float((aux[True][1] - aux[False][1]).abs().max())
    if aux_err > CTC_LOSS_RTOL or aux_grad > FB_POST64_ATOL:
        raise RuntimeError(f"the aux CTC term through K3 against the plain recursion: loss {aux_err}, gradient "
                           f"{aux_grad}")
    del enc, ctc_logits
    phase(47, f"the transducer loss on the card (B={Bc} rows of the first batch, T={Tc_}, U+1={U1c}; one frame, no "
              f"labels, no frames among them) against the float64 DP (rnnt_loss_np): {loss_err:.3g} relative "
              f"(limit {RNNT_LOSS_RTOL}), gradient {grad_err:.3g} from the DP's in float64 (rnnt_loss in "
              f"float32 on the CPU {cpu32_err:.3g}; limit {grad_limit:.3g}); the anti-diagonal DP {diag_small_ms:.2f} ms against the cell-at-a-time form "
              f"{cells_ms:.1f} ms on 4 x 80 x 16 ({cells_err:.3g} apart); loss and backward on the whole batch "
              f"B={Bf} T={Tf} U+1={Ul + 1} {full_ms:.1f} ms, "
              + ("device launches not measured" if dp_events is None else
                 f"{dp_events} device launches ({dp_events / Tf:.1f} a frame, {dp_events / (Tf + Ul):.1f} an "
                 f"anti-diagonal)")
              + f" (kernel launches {dp_launches}); the aux CTC "
              f"term through K3 against the plain recursion, loss {aux_err:.3g} relative, gradient {aux_grad:.3g}, "
              f"loss and backward {aux[True][2]:.1f} ms (plain {aux[False][2]:.1f} ms)")

    # ---- phase 48: RNN-T training at full width
    state, step = R.init_rnnt_train_state(model, cfg), R.make_rnnt_train_step(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    zero()
    metrics, step_ms = [], []
    for i in range(RNNT_STEPS):
        fb_i, lab_i, nl_i = labeled[i % len(labeled)]
        ms, (state, m) = wall(lambda: step(state, fb_i.feats, fb_i.n_frames, lab_i, nl_i))
        step_ms.append(ms)
        metrics.append(m)
    train_launches = counts()
    only("RNN-T training", train_launches, ("fb_forward", "fb_backward", "fb_combine"))
    losses = [m["loss"] for m in metrics]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"RNN-T training: losses {losses}")
    model.eval()
    frames = float(np.mean([int(f.n_frames.sum()) for f, _l, _n in labeled]))
    train = {"steps": RNNT_STEPS, "ms_per_step": float(np.median(step_ms[1:])), "first_step_ms": step_ms[0],
             "loss_first": losses[0], "loss_last": losses[-1], "frames_per_step": frames,
             "k3_launches_per_step": {k: v / RNNT_STEPS for k, v in train_launches.items() if v},
             "peak_gib": peak_gib(), "warm_start_copied": [copied, total]}
    phase(48, f"RNN-T training at full width (encoder LstmAm 2 x {NN_HIDDEN} warm-started from phase 31's CE model, "
              f"{copied} of {total} tensors copied; stateless prediction {model.pred_hidden}, joint "
              f"{model.joint_hidden}, aux CTC head; {V} phones + blank): {RNNT_STEPS} steps of a {RNNT_SCHEDULE}-step "
              f"schedule (peak lr {RNNT_LR:g}) over {len(labeled)} batches of up to {labels.shape[1]} labels "
              f"({frames:.0f} frames a step): {train['ms_per_step']:.1f} ms a step (median; first {step_ms[0]:.0f} "
              f"ms), peak {train['peak_gib']:.1f} GiB, loss {losses[0]:.3f} -> {losses[-1]:.3f}; launches "
              f"{train_launches} (K3's three a step, no K4 under autograd)")

    # ---- phase 49: the held-out decodes
    held = pipe.featurize(corpus, fcfg, bcfg, dev)

    def phones_of(words):
        return [lex.phones[p] for p in lex.words_to_phone_ids(words, interword_sil=False, edge_sil=False,
                                                              oov="skip")]

    def greedy_per(m, impl="label_loop"):
        refs, hyps = [], []
        for f in map(pipe.live_rows, held):
            for b, seq in enumerate(R.rnnt_greedy_decode_device(m, f.feats, f.n_frames, impl=impl)):
                refs.append(phones_of(f.words[b]))
                hyps.append([lex.phones[u] for u in seq])
        return corpus_wer(refs, hyps)

    zero()
    greedy_ms, (per, per_counts) = wall(lambda: greedy_per(model))
    greedy_launches = counts()
    only("the greedy decode", greedy_launches, ("lstm_scan",))
    per0 = greedy_per(untrained)[0]
    sdi = [per_counts.substitutions, per_counts.deletions, per_counts.insertions]
    if not per < min(0.5 * per0, RNNT_PER_MAX):
        raise RuntimeError(f"the trained RNN-T's held-out PER {per:.4f} (sub/del/ins {sdi}) against the untrained "
                           f"model's {per0:.4f} and the empty hypothesis's 1 (limit min(half the untrained, "
                           f"{RNNT_PER_MAX}))")
    fbw = max(held, key=lambda f: f.feats.shape[1])
    sub = pipe.live_rows(fbw)
    g_feats, g_nf = sub.feats[:RNNT_GREEDY_ROWS], sub.n_frames[:RNNT_GREEDY_ROWS]
    host_ms, host = wall(lambda: R.rnnt_greedy_decode(model, g_feats, g_nf))
    ll_ms, ll_tok = wall(lambda: R.rnnt_greedy_decode_device(model, g_feats, g_nf))
    fs_ms, fs_tok = wall(lambda: R.rnnt_greedy_decode_device(model, g_feats, g_nf, impl="frame_scan"))
    if not host == ll_tok == fs_tok:
        bad = [b for b in range(len(host)) if not host[b] == ll_tok[b] == fs_tok[b]]
        raise RuntimeError(f"the greedy decoders differ on rows {bad[:8]}")
    with torch.no_grad():
        enc_w = R.rnnt_encode(model, g_feats, g_nf)
    Tg = g_feats.shape[1]
    u_cap = min(2 * Tg, 400)
    ll_dec = R.make_rnnt_device_greedy(model, u_cap)
    fs_dec = R.make_rnnt_device_greedy(model, u_cap, impl="frame_scan")
    zero()
    ll_dev_ms = per_call_ms(lambda: ll_dec(enc_w, g_nf), 2)
    ll_launch_count = counts()
    fs_dev_ms = per_call_ms(lambda: fs_dec(enc_w, g_nf), 1)
    # device launches a frame: the label loop's over the whole batch, the
    # frame scan's (the same every frame) over its first 60 frames, as a
    # profiled window of all its launches takes the profiler ~a minute
    greedy_events = {}
    for name, dec, n in (("label_loop", ll_dec, Tg), ("frame_scan", fs_dec, 60)):
        try:
            greedy_events[name] = device_profile(lambda: dec(enc_w[:, :n], g_nf.clamp(max=n)),
                                                 names=("",))[3][""][1] / n
        except RuntimeError:
            greedy_events[name] = None   # not measured
    b_nf = sub.n_frames[:RNNT_BEAM_UTTS]
    b_feats = sub.feats[:RNNT_BEAM_UTTS, : int(b_nf.max())]   # the device beam runs every padded frame
    kw = dict(beam_size=RNNT_BEAM, u_cap=RNNT_U_CAP)
    beam_host_ms, want = wall(lambda: R.rnnt_beam_decode_batch(model, b_feats, b_nf, **kw))
    beam_dev_ms, got = wall(lambda: R.rnnt_beam_decode_device(model, b_feats, b_nf, **kw))
    beam_err = 0.0
    for g, w in zip(got, want):
        if [h for _s, h in g] != [h for _s, h in w]:
            raise RuntimeError(f"the device beam's ranked sequences differ from the batched host beam's: {g} / {w}")
        beam_err = max([beam_err] + [abs(a - b) / abs(b) for (a, _h), (b, _g) in zip(g, w)])
    if beam_err > RNNT_BEAM_RTOL:
        raise RuntimeError(f"the device beam's scores {beam_err} from the host beam's (limit {RNNT_BEAM_RTOL})")
    Bw, Tw = fbw.feats.shape[:2]
    k4_enc = k4_layer_times(model.encoder.cells[0], fbw.feats, fbw.n_frames)
    decode = {"per": per, "sub_del_ins": sdi, "untrained_per": per0, "greedy_ms": greedy_ms,
              "utts": sum(f.size for f in held), "greedy_rows": RNNT_GREEDY_ROWS, "host_greedy_ms": host_ms,
              "label_loop_ms": ll_ms, "frame_scan_rows_ms": fs_ms, "label_loop_device_ms": ll_dev_ms,
              "frame_scan_device_ms": fs_dev_ms, "label_loop_launches": ll_launch_count, "T": Tg,
              "device_launches_per_frame": greedy_events,
              "beam": {"utts": RNNT_BEAM_UTTS, "width": RNNT_BEAM, "device_ms": beam_dev_ms,
                       "host_batch_ms": beam_host_ms, "max_rel_err": beam_err}}
    phase(49, f"the {decode['utts']} held-out utterances: greedy (label loop, K4 on the encoder) PER {per:.4f} "
              f"(sub/del/ins {sdi} of {per_counts.ref_words} phones) in {greedy_ms:.0f} ms against the untrained "
              f"model's {per0:.4f} and the empty hypothesis's 1 (limit min(half the untrained, {RNNT_PER_MAX:g})) "
              f"(launches {greedy_launches}); on {RNNT_GREEDY_ROWS} rows of the widest batch (T={Tg}) the "
              f"host greedy ({host_ms:.0f} ms), the label loop ({ll_ms:.0f} ms; {ll_dev_ms:.1f} ms a call from the "
              f"encoder) and the frame scan ({fs_ms:.0f} ms; {fs_dev_ms:.1f} ms a call) give the same tokens on "
              f"every row (device launches a frame: {greedy_events}); the device beam (width {RNNT_BEAM}, u_cap {RNNT_U_CAP}) on {RNNT_BEAM_UTTS} utterances "
              f"the batched host beam's ranked sequences, scores {beam_err:.3g} relative, {beam_dev_ms:.0f} ms "
              f"(host {beam_host_ms:.0f} ms); K4 on the encoder's layer 0 at B={Bw} T={Tw} {k4_enc['ms']:.3f} ms "
              f"(plain {k4_enc['plain_ms']:.1f} ms, bound {k4_enc['bound_ms']:.4f} ms by {k4_enc['bound_by']}, max "
              f"|err| {k4_enc['max_abs_err']:.3g}); the whole layer {k4_enc['layer_ms']:.3f} ms vs cuDNN nn.LSTM "
              f"{k4_enc['library_ms']:.3f} ms")

    # ---- phase 50: pruned steps and MWER steps
    pruned = init_(R.build_rnnt_model(V, cfg, D, simple_heads=True), torch.Generator().manual_seed(5)).to(dev)
    pruned.load_state_dict(model.state_dict(), strict=False)
    p_state = R.init_rnnt_train_state(pruned, cfg)
    p_step = RP.make_rnnt_pruned_train_step(pruned, cfg, band=RNNT_BAND)
    zero()
    p_ms, p_loss = [], []
    fb0, lab0, nl0 = labeled[0]
    for _ in range(RNNT_PRUNED_STEPS):
        ms, (p_state, m) = wall(lambda: p_step(p_state, fb0.feats, fb0.n_frames, lab0, nl0))
        p_ms.append(ms)
        p_loss.append(m["loss"])
    pruned_launches = counts()
    if not np.isfinite(p_loss).all() or not p_loss[-1] < p_loss[0]:
        raise RuntimeError(f"pruned RNN-T steps on one batch: losses {p_loss}")
    mwer_model = copy.deepcopy(model)
    mrows = slice(0, RNNT_MWER_ROWS)
    m_fb = pipe.FeatBatch(fb0.utt_ids[mrows], fb0.feats[mrows], fb0.n_frames[mrows], fb0.words[mrows])
    seqs = [encode(w) for w in m_fb.words]
    u_max = max(map(len, seqs)) + 4
    zero()
    beam_ms, nbest = wall(lambda: R.rnnt_beam_decode_device(mwer_model, m_fb.feats, m_fb.n_frames, beam_size=4,
                                                            u_cap=u_max))
    hyps = np.full((RNNT_MWER_ROWS, 4, u_max), -1, np.int64)
    n_h, h_mask = np.zeros((RNNT_MWER_ROWS, 4), np.int64), np.zeros((RNNT_MWER_ROWS, 4), bool)
    risks = np.zeros((RNNT_MWER_ROWS, 4), np.float32)
    for b, lst in enumerate(nbest):
        for n, (_s, h) in enumerate(lst[:4]):
            hyps[b, n, : len(h)], n_h[b, n], h_mask[b, n] = h, len(h), True
            risks[b, n] = edit_counts(seqs[b], h).errors
    m_state = R.init_rnnt_train_state(mwer_model, cfg)
    m_step = R.make_rnnt_mwer_step(mwer_model, cfg)
    nb = [torch.as_tensor(a, device=dev) for a in (hyps, n_h, h_mask, risks)]
    m_lab, m_nl = lab0[mrows], nl0[mrows]
    m_ms, m_loss, m_risk = [], [], []
    for _ in range(RNNT_MWER_STEPS):
        ms, (m_state, m) = wall(lambda: m_step(m_state, m_fb.feats, m_fb.n_frames, *nb, m_lab, m_nl))
        m_ms.append(ms)
        m_loss.append(m["loss"])
        m_risk.append(m["expected_risk"])
    mwer_launches = counts()
    # the criterion MWER lowers is the expected risk (the anchor term beside it may rise)
    if not np.isfinite(m_loss + m_risk).all() or not m_risk[-1] < m_risk[0]:
        raise RuntimeError(f"MWER steps on a fixed N-best: losses {m_loss}, expected risks {m_risk}")
    del mwer_model, pruned
    steps50 = {"pruned": {"band": RNNT_BAND, "steps": RNNT_PRUNED_STEPS, "ms_per_step": float(np.median(p_ms[1:])),
                          "loss": p_loss},
               "mwer": {"rows": RNNT_MWER_ROWS, "steps": RNNT_MWER_STEPS, "ms_per_step": float(np.median(m_ms[1:])),
                        "beam_ms": beam_ms, "loss": m_loss, "expected_risk": m_risk}}
    phase(50, f"pruned RNN-T steps (band {RNNT_BAND}, fresh simple heads on phase 48's model) on one batch: "
              f"{steps50['pruned']['ms_per_step']:.1f} ms a step, loss {p_loss[0]:.3f} -> {p_loss[-1]:.3f} "
              f"(launches {pruned_launches}); MWER on {RNNT_MWER_ROWS} rows, the device beam's 4-best "
              f"({beam_ms:.0f} ms): {RNNT_MWER_STEPS} steps at {steps50['mwer']['ms_per_step']:.1f} ms, loss "
              f"{m_loss[0]:.4f} -> {m_loss[-1]:.4f}, expected risk {m_risk[0]:.3f} -> {m_risk[-1]:.3f} (launches "
              f"{mwer_launches}; `finetune_rnnt_mwer` runs in phase 54's train_nn --mwer-steps)")

    # ---- phase 51: streaming on K4's carry arm
    rows_s = min(64, sub.size)
    s_feats, s_nf = sub.feats[:rows_s], sub.n_frames[:rows_s]
    offline = R.rnnt_greedy_decode_device(model, s_feats, s_nf, impl="frame_scan")
    u_cap_s = min(2 * s_feats.shape[1], 400)
    zero()
    stream = R.RnntDeviceStream(model, rows_s, u_cap=u_cap_s)
    nf_np = s_nf.cpu().numpy()
    n_chunks = 0
    t0 = time.perf_counter()
    for c0 in range(0, s_feats.shape[1], ONLINE_TC):
        stream.consume(s_feats[:, c0:c0 + ONLINE_TC], np.clip(nf_np - c0, 0, ONLINE_TC))
        n_chunks += 1
    streamed = stream.partial()
    stream_s = time.perf_counter() - t0
    stream_launches = counts()
    only("the RNN-T stream", stream_launches, ("lstm_scan", "lstm_scan_carry"))
    if streamed != offline:
        bad = [b for b in range(rows_s) if streamed[b] != offline[b]]
        raise RuntimeError(f"the RNN-T stream differs from the offline greedy on rows {bad[:8]}")
    phase(51, f"RnntDeviceStream on {rows_s} held-out rows in {n_chunks} chunks of {ONLINE_TC} frames (ragged ends): "
              f"the offline greedy's tokens on every row, {stream_s:.2f} s; launches {stream_launches} (K4's carry "
              f"arm {stream_launches['lstm_scan_carry'] / n_chunks:.1f} a chunk)")

    # ---- phase 52: BatchedRnntEngine at the serving configuration
    B, Tc = SERVE_CAPACITY, SERVE_TICK
    sfcfg = dataclasses.replace(fcfg, cmvn="sliding", cmvn_window=SERVE_CMVN_WINDOW)
    event = Tc * sfcfg.frame_shift
    smodel = init_(R.build_rnnt_model(RNNT_SERVE_UNITS, cfg, D), torch.Generator().manual_seed(52)).to(dev)
    smodel.encoder.load_state_dict(model.encoder.state_dict())
    smodel.eval()
    sessions = [(uid, wave) for uid, wave, _w in corpus[:SERVE_CTC_UTTS]]
    gate = sessions[:RNNT_SERVE_GATE]

    def dedicated(subset):
        """The dedicated per-session path, the sessions as the rows of one
        RnntDeviceStream: each row's features from its own StreamingFrontend
        in the engine's audio events, fed a tick's frames at a time."""
        feats = []
        for _sid, wave in subset:
            fe = StreamingFrontend(sfcfg, device=dev)
            feats.append(np.concatenate([fe.process(wave[i:i + event]) for i in range(0, len(wave), event)]
                                        + [fe.finalize()]))
        n = np.asarray([f.shape[0] for f in feats])
        x = np.zeros((len(feats), int(n.max()), D), np.float32)
        for b, f in enumerate(feats):
            x[b, : f.shape[0]] = f
        x = torch.as_tensor(x, device=dev)
        st = R.RnntDeviceStream(smodel, len(feats), u_cap=int(n.max()) * 4 + 4)
        for c0 in range(0, x.shape[1], Tc):
            st.consume(x[:, c0:c0 + Tc], np.clip(n - c0, 0, Tc))
        return {sid: (seq, x[b], int(n[b])) for b, ((sid, _w), seq) in enumerate(zip(subset, st.partial()))}

    def run(feature_path, subset, windows=False):
        eng = BatchedRnntEngine(smodel, sfcfg, capacity=B, tick_frames=Tc, feature_path=feature_path, device=dev)
        drv = ServeLoop(eng, subset, event, SERVE_SEED, SERVE_PARTIAL_EVERY)
        zero()
        t0 = time.perf_counter()
        while not drv.done():
            if windows and not drv.sync_ticks and drv.eng.ticks == SERVE_WINDOW_AT:
                drv.count_syncs = True
                for _ in range(SERVE_PROFILE_TICKS):
                    drv.step()
                drv.count_syncs = False
            else:
                drv.step()
        torch.cuda.synchronize()
        return drv, time.perf_counter() - t0, counts()

    dedicated_s = dedicated(gate)
    want_s = {sid: seq for sid, (seq, _x, _n) in dedicated_s.items()}
    exact, _w, e_counts = run("host", gate)
    fast, s_wall, s_counts = run("device", sessions, windows=True)
    for name, c in (("the RNN-T engine (host features)", e_counts), ("the RNN-T engine (device features)", s_counts)):
        only(name, c, ("lstm_scan", "lstm_scan_carry"))
    # a session that differs must start to differ at a near-tie of the dedicated path
    ties = {}
    for name, drv in (("host features", exact), ("device features", fast)):
        ties[name] = {sid: rnnt_tie_gap(smodel, x, n, want_s[sid], drv.finals[sid][0])
                      for sid, (_seq, x, n) in dedicated_s.items() if drv.finals[sid][0] != want_s[sid]}
    if any(g > RNNT_TIE_GAP for t in ties.values() for g in t.values()):
        raise RuntimeError(f"the RNN-T engine's units differ from the dedicated stream's past a near-tie (top-2 "
                           f"joint logit gaps {ties}, limit {RNNT_TIE_GAP})")
    bad = list(ties["host features"])
    agree = len(want_s) - len(ties["device features"])
    periods = fast.tick_periods_ms()
    audio = sum(len(w) for _s, w in sessions) / sfcfg.sample_rate
    per_tick = {k: v / fast.eng.ticks for k, v in s_counts.items() if v}
    busy = None
    # the busy share: device time of a window of ticks over its wall time
    eng_b = BatchedRnntEngine(smodel, sfcfg, capacity=B, tick_frames=Tc, feature_path="device", device=dev)
    drv_b = ServeLoop(eng_b, sessions[:B], event, SERVE_SEED, SERVE_PARTIAL_EVERY)
    for _ in range(8):
        drv_b.step()
    try:   # a few ticks: the profiler's cost grows with the frame scan's ~3,000 launches a tick
        w_ms, d_ms, _top, _named = device_profile(lambda: [drv_b.step() for _ in range(RNNT_PROFILE_TICKS)])
        busy = d_ms / w_ms
    except RuntimeError:
        busy = None   # a profiled window without device activity: not measured
    del eng_b, drv_b
    rng = np.random.default_rng(52)
    nv_t = rng.integers(1, Tc + 1, size=B).astype(np.int32)
    nv_t[rng.choice(B, B // 8, replace=False)] = 0     # idle slots
    x_t = torch.as_tensor(rng.standard_normal((B, Tc, D)).astype(np.float32), device=dev)
    h0, c0 = (torch.as_tensor(rng.standard_normal((B, NN_HIDDEN)).astype(np.float32), device=dev) for _ in range(2))
    k4_tick = k4_layer_times(smodel.encoder.cells[0], x_t, torch.as_tensor(nv_t, device=dev), h0=h0, c0=c0, reps=20)
    engine = {"capacity": B, "tick_frames": Tc, "units": RNNT_SERVE_UNITS, "sessions": len(sessions),
              "audio_s": audio, "wall_s": s_wall, "streams_per_card": audio / s_wall,
              "tick_ms_median": float(np.median(periods)), "partial_ms_median": float(np.median(fast.partial_ms)),
              "launches_per_tick": per_tick, "syncs_per_tick": fast.syncs / max(fast.sync_ticks, 1),
              "sync_sites": fast.sync_sites, "busy_share": busy, "gate_sessions": len(want_s),
              "host_feature_agreement": len(want_s) - len(bad),
              "device_feature_agreement": agree, "tie_gaps": ties}
    phase(52, f"BatchedRnntEngine at the serving configuration (capacity {B}, {Tc}-frame ticks, V = "
              f"{RNNT_SERVE_UNITS} units, frame-scan greedy, sliding CMVN): units equal to the dedicated per-session "
              f"stream's on {len(want_s) - len(bad)} of the first {len(want_s)} sessions with host features; device "
              f"features on {len(sessions)} sessions: {agree} of {len(want_s)} equal (a session that differs must "
              f"start to at a top-2 joint logit gap of at most {RNNT_TIE_GAP:g} on the dedicated path: "
              + ("none differ" if not any(ties.values()) else
                 "; ".join(f"{k} {sid} gap {g:.3g}" for k, t in ties.items() for sid, g in t.items()))
              + f"), {audio:.1f} s of audio in {s_wall:.2f} s: "
              f"{audio / s_wall:.1f} realtime streams a card, a tick {engine['tick_ms_median']:.2f} ms median on the "
              f"device timeline, partials {engine['partial_ms_median']:.2f} ms, launches a tick "
              + ", ".join(f"{k} {v:.2f}" for k, v in per_tick.items())
              + f", {fast.syncs} synchronizing calls in {fast.sync_ticks} ticks {fast.sync_sites}, busy share "
              + ("not measured (the profiled window had no device activity)" if busy is None else f"{busy:.3f}")
              + f"; K4's carry arm at B={B} Tc={Tc} H={NN_HIDDEN} {k4_tick['ms']:.4f} ms a call, "
              f"{k4_tick['device_ms']:.4f} ms with the host hidden (plain {k4_tick['plain_ms']:.3f} ms, bound "
              f"{k4_tick['bound_ms']:.4f} ms by {k4_tick['bound_by']}, max |err| {k4_tick['max_abs_err']:.3g}); "
              f"the layer {k4_tick['layer_ms']:.4f} ms vs cuDNN nn.LSTM with (h0, c0) {k4_tick['library_ms']:.4f} ms")
    del exact, fast, smodel

    # ---- phase 53: the neural LMs
    train_texts = [w for fb_ in train_fbs for w in fb_.words[: fb_.size]]
    held_texts = [w for f in held for w in f.words[: f.size]]
    vocab = NL.vocab_from_transcripts(train_texts)
    zero()
    lms, lm_out = {}, {}
    for arch, layers in (("lstm", 1), ("transformer", 2)):
        lcfg = TrainConfig(nn_hidden=128, nn_layers=layers, lr=NNLM_LR, num_nn_steps=NNLM_STEPS)
        ms, (lm, _sd) = wall(lambda: NL.train_nnlm(train_texts, vocab, lcfg, batch_size=64, arch=arch, device=dev))
        lms[arch] = lm
        lm_out[arch] = {"train_ms_per_step": ms / NNLM_STEPS}
    nnlm_train_launches = counts()
    if any(nnlm_train_launches.values()):
        raise RuntimeError(f"NNLM training launched kernels: {nnlm_train_launches}")
    zero()
    for arch, lm in lms.items():
        ppl_k = NL.nnlm_perplexity(lm, vocab, held_texts)
        ppl_p = NL.nnlm_perplexity(lm, vocab, held_texts, use_kernels=False)
        if not abs(ppl_k - ppl_p) <= 1e-4 * ppl_p or not np.isfinite(ppl_k):
            raise RuntimeError(f"{arch} NNLM perplexity on the card {ppl_k} against plain {ppl_p}")
        lm_out[arch].update(heldout_ppl=ppl_k, plain_ppl=ppl_p)
    rng = np.random.default_rng(53)
    nbest = []
    for words in held_texts[:64]:
        alts = [list(words), list(words[1:]), list(words) + [words[0]], list(reversed(words))]
        nbest.append([(a, float(-rng.random())) for a in alts])
    for arch, lm in lms.items():
        got = NL.rescore_nbest_nnlm(lm, vocab, nbest)
        want_r = NL.rescore_nbest_nnlm(lm, vocab, nbest, use_kernels=False)
        if [[w for w, _s in r] for r in got] != [[w for w, _s in r] for r in want_r]:
            raise RuntimeError(f"{arch} NNLM rescoring orders differ between K4 and plain")
    lm_launches = counts()
    if lm_launches["lstm_scan"] == 0 or any(v for k, v in lm_launches.items() if k != "lstm_scan"):
        raise RuntimeError(f"the NNLM scorers' launches {lm_launches} (K4 only)")
    lstm_lm = lms["lstm"]
    seqs_h = [vocab.encode(s) for s in held_texts]
    inp, _tgt, n_h = NL.lm_batch(seqs_h, vocab, max(map(len, seqs_h)) + 1)
    with torch.no_grad():
        emb = lstm_lm.embedding(torch.as_tensor(inp, device=dev).long())
    k4_lm = k4_layer_times(lstm_lm.cells[0], emb, torch.as_tensor(n_h, device=dev))
    phase(53, f"the neural LMs on {len(train_texts)} training transcripts (vocab {vocab.n_tokens}), {NNLM_STEPS} steps "
              f"each: LSTM 128 x 1 {lm_out['lstm']['train_ms_per_step']:.1f} ms a step, held-out perplexity "
              f"{lm_out['lstm']['heldout_ppl']:.3f} on K4 (plain {lm_out['lstm']['plain_ppl']:.3f}); Transformer 64 "
              f"wide x 2 {lm_out['transformer']['train_ms_per_step']:.1f} ms a step, perplexity "
              f"{lm_out['transformer']['heldout_ppl']:.3f}; N-best rescoring of 64 x 4 the same order on the card as "
              f"plain (launches {lm_launches}); K4 on the LM's layer at B={k4_lm['shape'][0]} U={k4_lm['shape'][1]} "
              f"H=128 {k4_lm['ms']:.4f} ms (plain {k4_lm['plain_ms']:.3f} ms, bound {k4_lm['bound_ms']:.5f} ms by "
              f"{k4_lm['bound_by']}, max |err| {k4_lm['max_abs_err']:.3g}); the layer {k4_lm['layer_ms']:.4f} ms vs "
              f"cuDNN nn.LSTM {k4_lm['library_ms']:.4f} ms")
    return {"paths": {"rnnt_loss": dp_launches, "rnnt_train": train_launches, "rnnt_decode": greedy_launches,
                      "rnnt_label_loop": ll_launch_count, "rnnt_pruned": pruned_launches, "rnnt_mwer": mwer_launches,
                      "rnnt_stream": stream_launches, "serve_rnnt": s_counts, "serve_rnnt_exact": e_counts,
                      "nnlm": lm_launches},
            "train": train, "decode": decode, "steps": steps50, "engine": engine, "nnlm": lm_out,
            "k4_encoder": k4_enc, "k4_tick": k4_tick, "k4_nnlm": k4_lm,
            "loss": {"rel_err": loss_err, "grad_err": grad_err, "grad_cpu_float32_err": cpu32_err,
                     "grad_limit": grad_limit, "loss_and_backward_ms": full_ms, "cells_ms": cells_ms, "diagonal_small_ms": diag_small_ms, "device_launches": dp_events,
                     "shape": [Bf, Tf, Ul + 1]},
            "aux_ctc": {"loss_rel_err": aux_err, "grad_max_abs_err": aux_grad, "ms": aux[True][2],
                        "plain_ms": aux[False][2]}}


def rnnt_cli_phase(dev: torch.device) -> dict:
    """Phase 54: the RNN-T and neural-LM paths of the CLI twins in this
    process (their output to build/chip_smoke_rnnt_cli/out.txt), the launch
    counts set to 0 before and read after: train_lm (the neural LM),
    train_nn --objective rnnt (phones with --mwer-steps; BPE with
    --rnnt-pruned-band), decode --rnnt (phones greedily, held to the device
    greedy on the checkpoint; BPE words through the beam with
    --nnlm-rescore), eval --rnnt, stream --rnnt, transcribe --rnnt and serve
    --rnnt --engine."""
    import contextlib
    import io
    import shutil

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import lstm_cuda
    from mogasr_torch.am import rnnt as R
    from mogasr_torch.cli import decode as cli_decode
    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.cli import serve as cli_serve
    from mogasr_torch.cli import stream as cli_stream
    from mogasr_torch.cli import train_lm as cli_train_lm
    from mogasr_torch.cli import train_nn as cli_train_nn
    from mogasr_torch.cli import transcribe as cli_transcribe
    from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.hmm.lexicon import synthetic_lexicon
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke_rnnt_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    corpus = ["--synthetic", "8", "--synthetic-seed", "7"]
    on = ["--device", str(dev)]
    size = ["--nn-hidden", "128", "--nn-layers", "3"]
    ph, bp, lm = (os.path.join(work, d) for d in ("phones", "bpe", "lm"))
    train = ["--objective", "rnnt", "--arch", "lstm", "--hidden", "128", "--layers", "3"]
    runs = [
        (cli_train_lm, ["--synthetic", "16", "--synthetic-seed", "7", "--steps", "20", "--run-dir", lm]),
        (cli_train_nn, corpus + train + ["--steps", "4", "--mwer-steps", "1", "--run-dir", ph]),
        (cli_train_nn, corpus + train + ["--steps", "3", "--bpe-merges", "30", "--rnnt-pruned-band", "4",
                                         "--run-dir", bp]),
        (cli_decode, corpus + size + ["--rnnt", "--am", "lstm", "--nn-ckpt", os.path.join(ph, "nn_rnnt_lstm"),
                                      "--mode", "phone", "--out", os.path.join(work, "hyps.jsonl"), "--run-dir",
                                      os.path.join(work, "decode")]),
        (cli_decode, corpus + size + ["--rnnt", "--am", "lstm", "--nn-ckpt", os.path.join(bp, "nn_rnnt_lstm"),
                                      "--bpe", os.path.join(bp, "bpe.json"), "--rnnt-pruned", "--rnnt-beam", "2",
                                      "--nnlm-rescore", os.path.join(lm, "nnlm"), "--run-dir",
                                      os.path.join(work, "decode_bpe")]),
        (cli_eval, corpus + size + ["--rnnt", "--nn-arch", "lstm", "--nn-ckpt", os.path.join(bp, "nn_rnnt_lstm"),
                                    "--bpe", os.path.join(bp, "bpe.json"), "--rnnt-pruned", "--run-dir",
                                    os.path.join(work, "eval")]),
        (cli_stream, ["--synthetic-demo", "--rnnt", "--nn-ckpt", os.path.join(ph, "nn_rnnt_lstm"), "--run-dir",
                      os.path.join(work, "stream")] + size),
        (cli_transcribe, ["--synthetic-demo", "--rnnt", "--nn-arch", "lstm", "--nn-ckpt",
                          os.path.join(ph, "nn_rnnt_lstm"), "--run-dir", os.path.join(work, "transcribe")] + size),
        (cli_serve, ["--synthetic-demo-session", "--engine", "--rnnt", "--nn-ckpt", os.path.join(ph, "nn_rnnt_lstm"),
                     "--run-dir", os.path.join(work, "serve")] + size),
    ]
    zero_launches()
    lstm_cuda.CARRY_LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        for cli, argv in runs:
            cli.main(argv + on)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    launches.update(lstm_scan_carry=lstm_cuda.CARRY_LAUNCHES)
    with open(os.path.join(work, "out.txt"), "w") as f:
        f.write(buf.getvalue())
    needed = ("fb_forward", "fb_backward", "fb_combine", "lstm_scan", "lstm_scan_carry")
    if min(launches[k] for k in needed) == 0 or launches["gmm_score"] or launches["viterbi"]:
        raise RuntimeError(f"the RNN-T CLI twins did not go through every kernel of their path: {launches}")
    # decode --rnnt --mode phone against the device greedy on the checkpoint's model
    lex = synthetic_lexicon()
    utts = make_corpus(8, seed=7)
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], FrontendConfig(), BatchConfig(), dev)
    model = R.build_rnnt_model(lex.n_phones, TrainConfig(nn_hidden=128, nn_layers=3), FrontendConfig().feat_dim)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           restore_checkpoint(os.path.join(ph, "nn_rnnt_lstm"))["params"].items()})
    model.to(dev).eval()
    want = {}
    for fb in map(pipe.live_rows, batches):
        for uid, seq in zip(fb.utt_ids, R.rnnt_greedy_decode_device(model, fb.feats, fb.n_frames)):
            want[uid] = [lex.phones[u] for u in seq]
    with open(os.path.join(work, "hyps.jsonl")) as f:
        got = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
    if got != want:
        raise RuntimeError(f"decode --rnnt's hypotheses differ from the device greedy's on "
                           f"{[u for u in want if got.get(u) != want[u]][:8]}")
    recs = {}
    for name in ("decode", "decode_bpe", "eval"):
        with open(os.path.join(work, name, "metrics.jsonl")) as f:
            recs[name] = json.loads(f.read().splitlines()[-1])
        if recs[name]["utts"] != 8:
            raise RuntimeError(f"{name}: {recs[name]}")
    finals = [json.loads(line) for line in buf.getvalue().splitlines() if '"final"' in line]
    if len(finals) != 2:
        raise RuntimeError(f"stream and serve --rnnt printed {len(finals)} final lines")
    phase(54, f"the RNN-T and neural-LM CLI twins in this process, {seconds:.1f} s: train_lm (LSTM 128), train_nn "
              f"--objective rnnt (phones, --mwer-steps 1; BPE 30 merges, --rnnt-pruned-band 4), decode --rnnt "
              f"(phones: the device greedy's hypotheses on all 8; PER {recs['decode']['per']:.4f}), decode --rnnt "
              f"--bpe --rnnt-beam 2 --nnlm-rescore (WER {recs['decode_bpe']['wer']:.4f}), eval --rnnt (WER "
              f"{recs['eval']['wer']:.4f}; a few steps: no limit), stream, transcribe and serve --engine --rnnt; "
              f"launches {launches}")
    return launches


def aed_margins(model, feats, n_frames: int, beam: int, max_tokens: int) -> float:
    """The dedicated path's attention beam replayed on one session's padded
    features ([1, Tb, D], n_frames valid): the least gap between the K-th and
    (K+1)-th candidate of a step (a top-K boundary an ulp could move) and
    between the best two final hypotheses before rescoring: where a float
    order change in a batched call could have changed the result."""
    from mogasr_torch.am import aed as A

    K, U, V = beam, max_tokens, model.vocab
    dev = feats.device
    gaps = []
    with torch.no_grad():
        enc, n_out = model.encode(feats, torch.as_tensor([n_frames], device=dev))
        enc_k, n_out_k = enc.repeat(K, 1, 1), n_out.repeat(K)
        toks = torch.full((1, K, U), model.eos, dtype=torch.int64, device=dev)
        scores = torch.full((1, K), A.NEG_INF, device=dev)
        scores[0, 0] = 0.0
        fin = torch.zeros((1, K), dtype=torch.bool, device=dev)
        eos_only = torch.full((V,), A.NEG_INF, device=dev)
        eos_only[model.eos] = 0.0
        sos = torch.full((1, K, 1), model.sos, dtype=torch.int64, device=dev)
        for u in range(U):
            if bool(fin.all()):
                break
            logits = model.decode_logits(enc_k, n_out_k, torch.cat([sos, toks[:, :, :-1]], 2).reshape(K, U))
            logp = torch.log_softmax(logits[:, u], -1).reshape(1, K, V)
            logp[:, :, model.sos] = A.NEG_INF
            logp = torch.where(fin[..., None], eos_only, logp)
            vals, idx = torch.sort((scores[..., None] + logp).reshape(1, K * V), descending=True, stable=True)
            if float(vals[0, K]) > A.NEG_INF / 2:
                gaps.append(float(vals[0, K - 1] - vals[0, K]))
            src, tok = idx[:, :K] // V, idx[:, :K] % V
            toks = torch.gather(toks, 1, src[..., None].expand(1, K, U)).clone()
            toks[:, :, u] = tok
            fin = torch.gather(fin, 1, src) | (tok == model.eos)
            scores = vals[:, :K]
    gaps.append(float(scores[0, 0] - scores[0, 1]))
    return min(gaps)


def aed_phases(dev: torch.device, topo, fcfg, corpus, bcfg, train_fbs) -> dict:
    """Phases 55-60: the AED's training objective on the card (the aux CTC
    term on K3) against the CPU; training the chunked bench_serve-width model
    and its held-out beam decode (joint CTC rescoring on K3); the offline
    decode at bench_families.py's AED row, early exit against the fixed
    scan, and the rescoring on K3; the chunked stream against the offline
    chunk-masked encoder; BatchedAedEngine at bench_serve.py's configuration
    against the dedicated per-session finals; MWER. Returns each path's
    launch counts and the kernels line's AED sub-entries."""
    import copy
    import dataclasses
    import warnings

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import aed as A
    from mogasr_torch.am import ctc
    from mogasr_torch.am.params import init_
    from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
    from mogasr_torch.data import synthetic as syn
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder import forward_backward as fbd
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.hmm.lexicon import make_lexicon
    from mogasr_torch.serving.engine import BatchedAedEngine, _cast_floats, aed_final_max_tokens

    torch.cuda.empty_cache()
    lex = topo.lexicon
    V, D = lex.n_phones, fcfg.feat_dim
    arm_k3 = {fb_cuda.ARM_CHAIN: "chain", fb_cuda.ARM_BLOCK: "block", fb_cuda.ARM_GENERAL: "general"}
    k3 = ("fb_forward", "fb_backward", "fb_combine")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def only(name, c, allowed):
        if any(v for k, v in c.items() if k not in allowed) or min(c[k] for k in allowed) == 0:
            raise RuntimeError(f"{name}: launches {c} (only and every one of {allowed})")

    def arms():
        return sorted({arm_k3[a] for a in fb_cuda.LAST_ARMS.flatten().tolist()})

    def encode(words):
        return ctc.ctc_labels_from_words(lex, words)

    merged = ctc_batches(train_fbs)
    labeled = pipe._pack_ctc_targets(merged, encode)
    cfg = TrainConfig(nn_hidden=AED_HIDDEN, nn_layers=AED_LAYERS, lr=AED_LR, num_nn_steps=AED_SCHEDULE)
    untrained = pipe.aed_model_for(V, cfg, D, dev, chunk_frames=AED_CHUNK, left_chunks=AED_LEFT).eval()
    model = copy.deepcopy(untrained)

    # ---- phase 55: the objective on the card against the CPU's plain route
    fbw, labw, nlw = max(labeled, key=lambda x: x[0].feats.shape[1])
    rows = torch.arange(AED_CHECK_ROWS, device=dev)
    check = (fbw.feats[rows], fbw.n_frames[rows], labw[rows], nlw[rows])

    def objective(m, dtype, device):
        m.zero_grad(set_to_none=True)
        args = [a.to(device) for a in check]
        args[0] = args[0].to(dtype)
        with torch.enable_grad():
            loss, met = A.aed_objective(m, *args, ctc_weight=AED_CTC_WEIGHT)
            loss.backward()
        grads = {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
        return loss.item(), {k: v.item() for k, v in met.items()}, grads

    loss_c, met_c, grad_c = objective(model, torch.float32, dev)
    loss_32, met_32, grad_32 = objective(copy.deepcopy(model).cpu(), torch.float32, torch.device("cpu"))
    loss_64, _m64, grad_64 = objective(copy.deepcopy(model).cpu().double(), torch.float64, torch.device("cpu"))
    model.zero_grad(set_to_none=True)
    loss_err = abs(loss_c - loss_32) / abs(loss_32)
    grad_err = max(float((grad_c[n] - grad_64[n]).abs().max()) for n in grad_64)
    cpu32_err = max(float((grad_32[n] - grad_64[n]).abs().max()) for n in grad_64)
    grad_limit = max(AED_GRAD_RATIO * cpu32_err, FB_ERR_FLOOR)
    if not loss_err <= AED_LOSS_RTOL or not grad_err <= grad_limit:
        raise RuntimeError(f"aed_objective on the card against the CPU: loss {loss_err:.3g} relative (limit "
                           f"{AED_LOSS_RTOL}), gradient {grad_err:.3g} from float64 (the CPU's float32 "
                           f"{cpu32_err:.3g}; limit {grad_limit:.3g})")
    # the aux CTC term on the whole widest batch: K3, the plain recursion, torch's ctc_loss
    with torch.no_grad():
        _enc, n_out, ctc_logits = model.encode_with_ctc(fbw.feats, fbw.n_frames)
    blank = V
    aux = {}
    for use_kernels in (True, False):
        xc = ctc_logits.clone().requires_grad_()

        def aux_loss():
            xc.grad = None
            with torch.enable_grad():
                out = ctc.ctc_loss(xc, n_out, labw, nlw, use_kernels=use_kernels)
                out.sum().backward()
            return out.detach()

        aux_loss()
        ms, nll = timed(aux_loss, 3)
        aux[use_kernels] = (nll, xc.grad.clone(), ms)
        if use_kernels:
            aux_arms = arms()
    fit = n_out >= ctc.frames_needed(labw, nlw)
    n_short = int((~fit).sum())
    aux_err = float(((aux[True][0] - aux[False][0]).abs() / aux[False][0].abs())[fit].max())
    aux_grad = float((aux[True][1] - aux[False][1])[fit].abs().max())
    if aux_err > CTC_LOSS_RTOL or aux_grad > FB_POST64_ATOL:
        raise RuntimeError(f"the aux CTC term on K3 against the plain recursion: loss {aux_err}, gradient {aux_grad}")
    logp = torch.log_softmax(ctc_logits, -1)
    lp_tbc = logp.transpose(0, 1).contiguous()

    def library_loss():
        xl = lp_tbc.clone().requires_grad_()
        with torch.enable_grad():
            torch.nn.functional.ctc_loss(xl, labw.clamp(min=0).long(), n_out.long(), nlw.long(), blank=blank,
                                         reduction="sum", zero_infinity=True).backward()
        return xl.grad

    lib_ms, _ = timed(library_loss, 5)
    graphs = ctc.ctc_label_graphs(labw, nlw, blank)
    nf1 = n_out.clamp(min=1)
    k3_ms = queued_ms(lambda: fb_cuda.forward_backward(logp, graphs, nf1))
    k3_bound = fb_bounds({**graphs, "n_states": 2 * nlw + 1}, n_out, logp.shape[1])["pair"]
    Bw, Tw = fbw.feats.shape[:2]
    aux_entry = {"shape": [Bw, int(logp.shape[1]), int(graphs["emit_id"].shape[1])], "arm": aux_arms,
                 "loss_rel_err": aux_err, "grad_max_abs_err": aux_grad, "rows_that_cannot_fit": n_short,
                 "ms": k3_ms, "plain_ms": None, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
                 "loss_and_backward_ms": aux[True][2], "plain_loss_and_backward_ms": aux[False][2],
                 "library_loss_and_backward_ms": lib_ms}
    aux_entry["plain_ms"] = timed(lambda: fbd.forward_backward(logp, graphs, nf1), 1)[0]
    phase(55, f"aed_objective on the card (d_model {model.d_model}, {model.enc_blocks} encoder and "
              f"{model.dec_blocks} decoder blocks, chunk {AED_CHUNK} left {AED_LEFT}; the aux CTC term on K3) "
              f"against the CPU's plain route with the same weights on {AED_CHECK_ROWS} rows of the widest merged "
              f"batch (T={Tw}): loss {loss_c:.6f}, {loss_err:.3g} relative (limit {AED_LOSS_RTOL}); gradient "
              f"{grad_err:.3g} from a float64 run (the CPU's float32 {cpu32_err:.3g}; limit {grad_limit:.3g}); the "
              f"aux CTC term on the whole batch B={Bw} T'={aux_entry['shape'][1]} J={aux_entry['shape'][2]} "
              f"(K3's {aux_arms} arm; {n_short} rows whose labels cannot fit their subsampled frames): loss "
              f"{aux_err:.3g} relative to plain, gradient {aux_grad:.3g}; loss and backward {aux[True][2]:.2f} ms "
              f"(plain {aux[False][2]:.1f} ms, torch's ctc_loss {lib_ms:.2f} ms); K3's three launches "
              f"{k3_ms:.3f} ms (plain forward-backward {aux_entry['plain_ms']:.1f} ms, bound {k3_bound[0]:.3g} ms)")

    # ---- phase 56: training, then the held-out beam decode
    state, step = A.init_aed_train_state(model, cfg), A.make_aed_train_step(model, cfg, ctc_weight=AED_CTC_WEIGHT)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses = []
    fb_i, lab_i, nl_i = labeled[0]
    first_ms, (state, m) = wall(lambda: step(state, fb_i.feats, fb_i.n_frames, lab_i, nl_i))
    losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, AED_STEPS):   # no read of the card a step: the host queues step i+1 while it runs step i
        fb_i, lab_i, nl_i = labeled[i % len(labeled)]
        state, m = step(state, fb_i.feats, fb_i.n_frames, lab_i, nl_i)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / max(AED_STEPS - 1, 1)
    losses = [float(x) for x in losses]
    train_launches = launch_counts()
    only("AED training", train_launches, k3)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"AED training: losses {losses[:4]} ... {losses[-4:]}")
    model.eval()
    train = {"steps": AED_STEPS, "schedule": AED_SCHEDULE, "lr": AED_LR, "ms_per_step": loop_ms,
             "first_step_ms": first_ms, "loss_first": losses[0], "loss_last": losses[-1],
             "k3_launches_per_step": {k: v / AED_STEPS for k, v in train_launches.items() if v},
             "peak_gib": peak_gib()}
    held = pipe.featurize(corpus, fcfg, bcfg, dev)

    def phones_of(words):
        return [lex.phones[p] for p in lex.words_to_phone_ids(words, interword_sil=False, edge_sil=False,
                                                              oov="skip")]

    def beam_per(m):
        dec = A.make_aed_decoder(m, beam=AED_BEAM, max_tokens=AED_MAX_TOKENS, ctc_weight=AED_CTC_WEIGHT)
        refs, hyps, steps = [], [], []
        for f in map(pipe.live_rows, held):
            toks, n, _s = dec(f.feats, f.n_frames)
            steps.append(dec.steps_run)
            toks, n = toks.cpu().numpy(), n.cpu().numpy()
            for b in range(f.size):
                refs.append(phones_of(f.words[b]))
                hyps.append([lex.phones[u] for u in toks[b, : n[b]]])
        return corpus_wer(refs, hyps), steps

    zero_launches()
    dec_ms, ((per, per_counts), dec_steps) = wall(lambda: beam_per(model))
    decode_launches = launch_counts()
    only("the AED beam decode", decode_launches, k3)
    (per0, _c0), _s0 = beam_per(untrained)
    sdi = [per_counts.substitutions, per_counts.deletions, per_counts.insertions]
    if not per < min(0.5 * per0, AED_PER_MAX):
        raise RuntimeError(f"the trained AED's held-out PER {per:.4f} (sub/del/ins {sdi}) against the untrained "
                           f"model's {per0:.4f} (limit min(half the untrained, {AED_PER_MAX}))")
    n_held = sum(f.size for f in held)
    decode = {"per": per, "sub_del_ins": sdi, "untrained_per": per0, "utts": n_held, "ms": dec_ms,
              "utt_per_s": n_held / (dec_ms / 1e3), "steps_per_batch": dec_steps}
    phase(56, f"AED training at bench_serve.py's width (chunked: {AED_CHUNK} subsampled frames a chunk, {AED_LEFT} "
              f"left; {V} phones, {model.vocab} decoder tokens) from its seeded initialisation: {AED_STEPS} steps of a "
              f"{AED_SCHEDULE}-step schedule "
              f"(peak lr {AED_LR:g}) over {len(labeled)} merged batches: {train['ms_per_step']:.1f} ms a step "
              f"(the loop's mean; first {first_ms:.0f} ms), peak {train['peak_gib']:.1f} GiB, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}, launches {train_launches} (K3's three a step); the {n_held} held-out utterances "
              f"through the beam (width {AED_BEAM}, {AED_MAX_TOKENS} tokens, CTC weight {AED_CTC_WEIGHT}): PER "
              f"{per:.4f} (sub/del/ins {sdi}; untrained {per0:.4f}; limit min(half the untrained, {AED_PER_MAX})) in "
              f"{dec_ms:.0f} ms ({decode['utt_per_s']:.1f} utt/s), loop steps a batch {dec_steps}, launches "
              f"{decode_launches}")

    # ---- phase 57: the offline decode at bench_families.py's AED row, random weights
    fam_words = syn.extended_lexicon(HYB_VOCAB)
    fam_lex = make_lexicon(fam_words)
    fam_corpus = [(u.utt_id, u.wave, u.words) for u in syn.make_corpus_v2(
        HYB_UTTS, lexicon=fam_words, n_speakers=HYB_SPEAKERS, seed=HYB_SEED, words_per_utt=(3, 9))]
    fam_fbs = [pipe.live_rows(f) for f in pipe.featurize(fam_corpus, FrontendConfig(), BatchConfig(
        batch_size=AED_FAM_BATCH, bucket_boundaries=HYB_BUCKETS), dev)]
    fcfg_fam = TrainConfig(nn_hidden=AED_FAM_HIDDEN, nn_layers=AED_FAM_LAYERS)
    fam = init_(A.build_aed_model(fam_lex.n_phones, fcfg_fam, FrontendConfig().feat_dim),
                torch.Generator().manual_seed(57)).to(dev).eval()
    early = A.make_aed_decoder(fam, beam=AED_BEAM, max_tokens=AED_FAM_TOKENS)
    scan = A.make_aed_decoder(fam, beam=AED_BEAM, max_tokens=AED_FAM_TOKENS, early_exit=False)

    def run_all(dec):
        out, steps = [], []
        for f in fam_fbs:
            toks, n, sc = dec(f.feats, f.n_frames)
            out.append((toks.cpu(), n.cpu(), sc.cpu()))
            steps.append(dec.steps_run)
        return out, steps

    run_all(early)
    zero_launches()
    fam_ms, (got, fam_steps) = wall(lambda: run_all(early))
    fam_launches = launch_counts()
    if any(fam_launches.values()):
        raise RuntimeError(f"the AED decode without rescoring launched kernels: {fam_launches}")
    scan_ms, (want, _st) = wall(lambda: run_all(scan))
    for (gt, gn, gs), (wt, wn, ws) in zip(got, want):
        if not (torch.equal(gt, wt) and torch.equal(gn, wn) and torch.equal(gs, ws)):
            raise RuntimeError("the early exit's tokens differ from the fixed scan's")
    f0 = fam_fbs[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            early(f0.feats, f0.n_frames)[0].cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    try:
        events = device_profile(lambda: early(f0.feats, f0.n_frames), names=("",))[3][""][1]
        launches_per_step = events / early.steps_run
    except RuntimeError:
        launches_per_step = None   # a profiled window without device activity: not measured
    n_fam = sum(f.size for f in fam_fbs)
    resc = A.make_aed_decoder(fam, beam=AED_BEAM, max_tokens=AED_FAM_TOKENS, ctc_weight=AED_CTC_WEIGHT)
    zero_launches()
    resc_ms, _r = wall(lambda: resc(f0.feats, f0.n_frames))
    resc_launches = launch_counts()
    only("the AED decode with the joint CTC rescoring", resc_launches, k3)
    resc_arms = arms()
    # the rescoring alone: the K hypotheses of every row against the CTC head, K3 and plain
    with torch.no_grad():
        toks, n_toks, _sc = A.make_aed_decoder(fam, beam=AED_BEAM, max_tokens=AED_FAM_TOKENS, return_all=True)(
            f0.feats, f0.n_frames)
        _e, n_out0, ctc0 = fam.encode_with_ctc(f0.feats, f0.n_frames)
    Kb, Lw = AED_BEAM, max(int(n_toks.max()), 1)
    lab_r = torch.where(torch.arange(Lw, device=dev) < n_toks[..., None], toks[:, :, :Lw], -1).reshape(-1, Lw)
    nl_r, nout_r = n_toks.reshape(-1), torch.repeat_interleave(n_out0, Kb)
    ctc_r = torch.repeat_interleave(ctc0, Kb, dim=0)
    with torch.no_grad():
        r_k3 = ctc.ctc_loss(ctc_r, nout_r, lab_r, nl_r)
        r_plain = ctc.ctc_loss(ctc_r, nout_r, lab_r, nl_r, use_kernels=False)
    fit_r = nout_r >= ctc.frames_needed(lab_r, nl_r)
    r_err = float(((r_k3 - r_plain).abs() / r_plain.abs())[fit_r].max()) if bool(fit_r.any()) else 0.0
    if r_err > CTC_LOSS_RTOL or not torch.equal(r_k3[~fit_r] > 1e29, r_plain[~fit_r] > 1e29):
        raise RuntimeError(f"the rescoring's CTC term on K3 against plain: {r_err}")
    rk3_ms = queued_ms(lambda: ctc.ctc_loss(ctc_r, nout_r, lab_r, nl_r))
    rplain_ms, _ = timed(lambda: ctc.ctc_loss(ctc_r, nout_r, lab_r, nl_r, use_kernels=False), 1)
    lp_r = torch.log_softmax(ctc_r, -1).transpose(0, 1).contiguous()
    rlib_ms = queued_ms(lambda: torch.nn.functional.ctc_loss(
        lp_r, lab_r.clamp(min=0), nout_r, nl_r, blank=fam.n_units, reduction="none", zero_infinity=True))
    g_r = ctc.ctc_label_graphs(lab_r, nl_r, fam.n_units)
    r_bound = fb_bounds({**g_r, "n_states": 2 * nl_r + 1}, nout_r, ctc_r.shape[1])["pair"]
    rescore = {"shape": [int(lab_r.shape[0]), int(ctc_r.shape[1]), int(g_r["emit_id"].shape[1])], "arm": resc_arms,
               "rows_that_cannot_fit": int((~fit_r).sum()), "loss_rel_err": r_err, "ms": rk3_ms,
               "plain_ms": rplain_ms, "bound_ms": r_bound[0], "bound_by": r_bound[1], "library_ms": rlib_ms,
               "launches_per_decode": {k: v for k, v in resc_launches.items() if v}, "decode_ms": resc_ms}
    fam_entry = {"d_model": fam.d_model, "utts": n_fam, "ms": fam_ms, "utt_per_s": n_fam / (fam_ms / 1e3),
                 "scan_ms": scan_ms, "steps": fam_steps, "device_launches_per_step": launches_per_step,
                 "host_syncs_per_decode": syncs}
    phase(57, f"the offline decode at bench_families.py's AED row (d_model {fam.d_model}, {fam.enc_blocks} encoder "
              f"and {fam.dec_blocks} decoder block, {fam_lex.n_phones} phones, random weights; beam {AED_BEAM}, "
              f"{AED_FAM_TOKENS} tokens) of its {n_fam} utterances in batches of {AED_FAM_BATCH}: {fam_ms:.0f} ms "
              f"({fam_entry['utt_per_s']:.1f} utt/s), loop steps {fam_steps}; tokens, lengths and scores of the "
              f"early exit equal to the fixed scan's ({scan_ms:.0f} ms); "
              + ("device launches a step not measured" if launches_per_step is None else
                 f"{launches_per_step:.1f} device launches a step")
              + f", {syncs} host syncs a decode; with CTC weight {AED_CTC_WEIGHT} on the first batch: launches "
              f"{rescore['launches_per_decode']} (K3's {resc_arms} arm), the rescoring's CTC term on "
              f"{rescore['shape']} (B K, T', J; {rescore['rows_that_cannot_fit']} hypotheses that cannot fit keep "
              f"~1e30) {r_err:.3g} relative to plain: K3 {rk3_ms:.3f} ms, plain {rplain_ms:.1f} ms, torch's ctc_loss "
              f"{rlib_ms:.3f} ms, bound {r_bound[0]:.3g} ms")

    # ---- phase 58: the chunked stream against the offline chunk-masked encoder
    T_s = 4 * AED_CHUNK * AED_STREAM_CHUNKS
    cand = [(f, b) for f in held for b in range(f.size) if int(f.n_frames[b]) >= T_s][:AED_STREAM_ROWS]
    x_s = torch.stack([f.feats[b, :T_s] for f, b in cand])
    nf_s = torch.full((len(cand),), T_s, device=dev)
    step_s = A.make_aed_stream_step(model)
    with torch.no_grad():
        enc_off, _n, ctc_off = model.encode_with_ctc(x_s, nf_s)
    st = A.aed_stream_init(model, len(cand), D)
    raw = 4 * AED_CHUNK
    encs, ctcs = [], []
    for c in range(AED_STREAM_CHUNKS):
        e, l_, st = step_s(x_s[:, c * raw:(c + 1) * raw], st)
        encs.append(e)
        ctcs.append(l_)
    s_err = float((torch.cat(encs, 1) - enc_off).abs().max())
    c_err = float((torch.cat(ctcs, 1) - ctc_off).abs().max())
    c_scale = float(ctc_off.abs().max())
    if s_err > AED_STREAM_ATOL or c_err > AED_STREAM_ATOL * max(c_scale, 1.0):
        raise RuntimeError(f"the chunk step against the offline chunk-masked encoder: enc {s_err} (atol "
                           f"{AED_STREAM_ATOL}), CTC logits {c_err} (atol {AED_STREAM_ATOL} x their largest "
                           f"magnitude {c_scale:.3g})")
    st0 = A.aed_stream_init(model, len(cand), D)
    chunk_ms = queued_ms(lambda: step_s(x_s[:, :raw], st0))
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    st16 = A.aed_stream_init(model, len(cand), D)
    agree = 0
    with torch.no_grad():
        for c in range(AED_STREAM_CHUNKS):
            _e, l16, new = m16.encode_stream_step(x_s[:, c * raw:(c + 1) * raw].to(torch.bfloat16),
                                                  _cast_floats(st16, torch.bfloat16))
            st16 = _cast_floats(new, torch.float32)
            agree += int((l16.float().argmax(-1) == ctcs[c].argmax(-1)).sum())
    n_dec = len(cand) * AED_STREAM_CHUNKS * AED_CHUNK
    stream = {"rows": len(cand), "chunks": AED_STREAM_CHUNKS, "enc_max_abs_err": s_err, "ctc_max_abs_err": c_err,
              "ctc_max_abs": c_scale,
              "chunk_ms": chunk_ms, "bf16_decisions_agree": agree, "decisions": n_dec}
    phase(58, f"the chunked stream of phase 56's model on {len(cand)} held-out rows, {AED_STREAM_CHUNKS} chunks of "
              f"{raw} frames: the encoder within {s_err:.3g} of the offline chunk-masked encoder (atol "
              f"{AED_STREAM_ATOL}), the CTC head within {c_err:.3g} (logits up to {c_scale:.3g}; atol "
              f"{AED_STREAM_ATOL} x that); {chunk_ms:.3f} ms a chunk step for all rows; the "
              f"step in bfloat16 (caches float32) agrees with float32 on {agree} of {n_dec} CTC-greedy frame "
              f"decisions")

    # ---- phase 59: BatchedAedEngine at bench_serve.py's configuration
    B = SERVE_CAPACITY
    sfcfg = dataclasses.replace(fcfg, cmvn="sliding", cmvn_window=SERVE_CMVN_WINDOW)
    event = SERVE_TICK * sfcfg.frame_shift
    sessions = [(uid, wave) for uid, wave, _w in corpus[:AED_SERVE_UTTS]]
    gate = sessions[:AED_SERVE_GATE]
    opts = dict(capacity=B, beam=AED_BEAM, ctc_weight=AED_CTC_WEIGHT, final_bucket=AED_FINAL_BUCKET, device=dev)

    def dedicated(subset):
        """The per-session server's finals: each session's features in the
        engine's audio events, padded to its bucket, the beam at the bucket's
        budget (the sessions of one bucket in one call: beam rows are
        independent). -> {sid: (units, padded [1, Tb, D], frames, Tb)}."""
        feats = {}
        for sid, wave in subset:
            fe = StreamingFrontend(sfcfg, device=dev)
            feats[sid] = np.concatenate([fe.process(wave[i:i + event]) for i in range(0, len(wave), event)]
                                        + [fe.finalize()])
        out, by_tb = {}, {}
        for sid, f in feats.items():
            by_tb.setdefault(-(-f.shape[0] // AED_FINAL_BUCKET) * AED_FINAL_BUCKET, []).append(sid)
        for Tb, sids in by_tb.items():
            padded = torch.zeros((len(sids), Tb, D), device=dev)
            for i, sid in enumerate(sids):
                padded[i, : feats[sid].shape[0]] = torch.as_tensor(feats[sid], device=dev)
            nf = [feats[sid].shape[0] for sid in sids]
            seqs = A.aed_decode_batch(model, padded, nf, beam=AED_BEAM, max_tokens=aed_final_max_tokens(Tb),
                                      ctc_weight=AED_CTC_WEIGHT)
            for i, sid in enumerate(sids):
                out[sid] = (seqs[i], padded[i:i + 1], nf[i], Tb)
        return out

    def run(feature_path, subset, windows=False):
        """Every session through an engine; with windows, a sync-counting
        window of SERVE_PROFILE_TICKS ticks from tick SERVE_WINDOW_AT (its
        sessions ending: finals in the ticks), then the busy share of
        AED_PROFILE_TICKS ticks from the card's activity alone (recording
        the host's ops too took 43.1 s to read back). -> (the ServeLoop, wall s,
        launches, busy share or None)."""
        eng = BatchedAedEngine(model, sfcfg, feature_path=feature_path, **opts)
        drv = ServeLoop(eng, subset, event, SERVE_SEED, SERVE_PARTIAL_EVERY)
        busy = None
        zero_launches()
        t0 = time.perf_counter()
        while not drv.done():
            if windows and not drv.sync_ticks and drv.eng.ticks == SERVE_WINDOW_AT:
                drv.count_syncs = True
                for _ in range(SERVE_PROFILE_TICKS):
                    drv.step()
                drv.count_syncs = False
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    for _ in range(AED_PROFILE_TICKS):
                        drv.step()
                    torch.cuda.synchronize()
                    w_ms = 1e3 * (time.perf_counter() - t1)
                d_ms = sum(e.device_time_total for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                busy = d_ms / w_ms if d_ms > 0 else None   # None: no device activity recorded, not measured
            else:
                drv.step()
        torch.cuda.synchronize()
        return drv, time.perf_counter() - t0, launch_counts(), busy

    parts = {}
    t0 = time.perf_counter()
    ded = dedicated(gate)
    parts["dedicated"] = time.perf_counter() - t0
    exact, parts["host_run"], e_counts, _b = run("host", gate[:AED_HOST_GATE])
    fast, s_wall, s_counts, busy = run("device", sessions, windows=True)
    for name, c in (("the AED engine (host features)", e_counts), ("the AED engine (device features)", s_counts)):
        only(name, c, k3)
    final_arms = arms()
    ties = {}
    for name, drv in (("host features", exact), ("device features", fast)):
        ties[name] = {sid: aed_margins(model, p, n, AED_BEAM, aed_final_max_tokens(Tb))
                      for sid, (seq, p, n, Tb) in ded.items() if sid in drv.finals and drv.finals[sid][0] != seq}
    if any(g > AED_TIE_GAP for t in ties.values() for g in t.values()):
        raise RuntimeError(f"the AED engine's finals differ from the per-session finals past a near-tie (least "
                           f"beam gaps {ties}, limit {AED_TIE_GAP})")
    # finalize_many against finalize on drained sessions
    few = sessions[:AED_FINALIZE_CHECK]

    def drained_engine():
        eng = BatchedAedEngine(model, sfcfg, feature_path="device", **{**opts, "capacity": len(few)})
        for sid, wave in few:
            eng.start(sid)
            eng.feed(sid, wave)
            eng.end(sid)
        while not all(eng.drained(sid) for sid, _w in few):
            eng.tick()
        return eng

    t0 = time.perf_counter()
    many = drained_engine().finalize_many([sid for sid, _w in few])
    one = drained_engine()
    singles = {sid: one.finalize(sid) for sid, _w in few}
    if any(many[sid][0] != singles[sid][0] for sid, _w in few):
        raise RuntimeError("finalize_many differs from finalize")
    parts["finalize_check"] = time.perf_counter() - t0
    periods = fast.tick_periods_ms()
    audio = sum(len(w) for _s, w in sessions) / sfcfg.sample_rate
    refs = {uid: phones_of(words) for uid, _w, words in corpus}
    per_e = corpus_wer([refs[s] for s, _w in sessions], [[lex.phones[u] for u in fast.finals[s][0]]
                                                         for s, _w in sessions])[0]
    engine = {"capacity": B, "tick_frames": 4 * AED_CHUNK, "sessions": len(sessions), "audio_s": audio,
              "wall_s": s_wall, "streams_per_card": audio / s_wall, "tick_ms_median": float(np.median(periods)),
              "partial_ms_median": float(np.median(fast.partial_ms)),
              "launches_per_tick": {k: v / fast.eng.ticks for k, v in s_counts.items() if v},
              "syncs_per_tick": fast.syncs / max(fast.sync_ticks, 1), "sync_sites": fast.sync_sites,
              "busy_share": busy, "gate_sessions": len(ded), "tie_gaps": ties, "final_arms": final_arms,
              "per": per_e, "finals_k3_launches": {k: v for k, v in s_counts.items() if v}, "parts_s": parts}
    phase(59, f"BatchedAedEngine at bench_serve.py's configuration on phase 56's model (capacity {B}, "
              f"{4 * AED_CHUNK}-frame ticks, beam {AED_BEAM}, CTC weight {AED_CTC_WEIGHT}, finals padded to "
              f"{AED_FINAL_BUCKET} frames, sliding CMVN): finals equal to the per-session finals on "
              f"{len(exact.finals) - len(ties['host features'])} of the first {len(exact.finals)} sessions with host "
              f"features "
              f"and {len(ded) - len(ties['device features'])} of the first {len(ded)} with device features (a final "
              f"that differs must have a "
              f"beam gap of at most {AED_TIE_GAP:g}: "
              + ("none differ" if not any(ties.values()) else f"gaps {ties}")
              + f"); finalize_many equal to finalize on {len(few)} drained sessions; the first {len(sessions)} "
              f"held-out "
              f"utterances ({audio:.0f} s of audio) on device features in {s_wall:.1f} s: "
              f"{engine['streams_per_card']:.1f} realtime streams a card, {engine['tick_ms_median']:.2f} ms a tick "
              f"(median), partials {engine['partial_ms_median']:.1f} ms, launches a tick "
              f"{ {k: round(v, 3) for k, v in engine['launches_per_tick'].items()} } (K3 in the finals only, its "
              f"{final_arms} arm), {engine['syncs_per_tick']:.2f} synchronizing calls a tick "
              f"({fast.sync_sites}), busy share "
              + ("not measured" if busy is None else f"{busy:.3f}") + f"; PER {per_e:.4f}; the phase's other parts s "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))

    # ---- phase 60: MWER
    mfb, mlab, mnl = labeled[0]
    rows_m = torch.arange(AED_MWER_ROWS, device=dev)
    fb_m = pipe.FeatBatch([mfb.utt_ids[i] for i in range(AED_MWER_ROWS)], mfb.feats[rows_m], mfb.n_frames[rows_m],
                          [mfb.words[i] for i in range(AED_MWER_ROWS)])
    mwer_model = copy.deepcopy(model)
    mcfg = TrainConfig(nn_hidden=AED_HIDDEN, nn_layers=AED_LAYERS, lr=AED_MWER_LR, num_nn_steps=AED_MWER_SCHEDULE)
    zero_launches()
    mwer_ms, (_sd, hist) = wall(lambda: pipe.finetune_aed_mwer(mwer_model, [fb_m], encode, mcfg, n_hyps=AED_BEAM,
                                                               steps=AED_MWER_STEPS))
    mwer_launches = launch_counts()
    if any(mwer_launches.values()):
        raise RuntimeError(f"MWER launched kernels: {mwer_launches}")
    if not hist[-1] < hist[0]:
        raise RuntimeError(f"MWER's expected risk did not fall: {hist}")
    del mwer_model
    mwer = {"steps": AED_MWER_STEPS, "rows": AED_MWER_ROWS, "ms_per_step": mwer_ms / AED_MWER_STEPS,
            "expected_risk": hist}
    phase(60, f"MWER: {AED_MWER_STEPS} finetune_aed_mwer steps (the beam's {AED_BEAM}-best against the current "
              f"weights, host edit distances, peak lr {AED_MWER_LR:g}) on {AED_MWER_ROWS} rows: expected risk "
              f"{' -> '.join(f'{h:.3f}' for h in hist)}, {mwer['ms_per_step']:.0f} ms a step")
    return {"paths": {"aed_train": train_launches, "aed_decode": decode_launches, "aed_engine": s_counts},
            "aux_ctc": aux_entry, "rescore": rescore, "train": train, "decode": decode, "families": fam_entry,
            "stream": stream, "engine": engine, "mwer": mwer,
            "objective": {"loss_rel_err": loss_err, "grad_err": grad_err, "cpu32_grad_err": cpu32_err}}


def aed_cli_phase(dev: torch.device) -> dict:
    """Phase 61: the AED paths of the CLI twins in this process (their output
    to build/chip_smoke_aed_cli/out.txt), the launch counts set to 0 before
    and read after: train_nn --objective aed --aed-chunk 8 --bpe-merges
    --mwer-steps 1, then decode --aed --bpe, eval --aed --bpe, stream --aed,
    transcribe --aed and serve --aed --engine, each held to the pipeline
    functions on the checkpoint's model on the same features."""
    import contextlib
    import io
    import shutil

    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import aed as A
    from mogasr_torch.cli import decode as cli_decode
    from mogasr_torch.cli import eval as cli_eval
    from mogasr_torch.cli import serve as cli_serve
    from mogasr_torch.cli import stream as cli_stream
    from mogasr_torch.cli import train_nn as cli_train_nn
    from mogasr_torch.cli import transcribe as cli_transcribe
    from mogasr_torch.config import BatchConfig, FrontendConfig, TrainConfig
    from mogasr_torch.data.bpe import load_bpe
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.frontend.streaming import StreamingFrontend
    from mogasr_torch.frontend.vad import VadConfig, segment_utterances
    from mogasr_torch.serving.engine import aed_final_max_tokens
    from mogasr_torch.utils.checkpoint import restore_checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke_aed_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    run_dir = os.path.join(work, "train")
    corpus = ["--synthetic", "8", "--synthetic-seed", "7"]
    on = ["--device", str(dev)]
    size = ["--nn-hidden", "128", "--nn-layers", "2"]
    ck = os.path.join(run_dir, "nn_aed_conformer")
    model_args = ["--nn-ckpt", ck, *size, "--bpe", os.path.join(run_dir, "bpe.json")]
    runs = [
        (cli_train_nn, corpus + ["--objective", "aed", "--arch", "conformer", "--hidden", "128", "--layers", "2",
                                 "--steps", "4", "--aed-chunk", "8", "--bpe-merges", "30", "--mwer-steps", "1",
                                 "--run-dir", run_dir]),
        (cli_decode, corpus + model_args + ["--aed", "--aed-chunk", "8", "--out", os.path.join(work, "hyps.jsonl"),
                                            "--run-dir", os.path.join(work, "decode")]),
        (cli_eval, corpus + model_args + ["--aed", "--run-dir", os.path.join(work, "eval")]),
        (cli_stream, ["--synthetic-demo", "--aed", "--aed-chunk", "8", *model_args, "--run-dir",
                      os.path.join(work, "stream")]),
        (cli_transcribe, ["--synthetic-demo", "--aed", "--aed-chunk", "8", *model_args, "--run-dir",
                          os.path.join(work, "transcribe")]),
        (cli_serve, ["--synthetic-demo-session", "--engine", "--feature-path", "host", "--aed", "--aed-chunk", "8",
                     *model_args, "--run-dir", os.path.join(work, "serve")]),
    ]
    zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        for cli, argv in runs:
            cli.main(argv + on)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(work, "out.txt"), "w") as f:
        f.write(buf.getvalue())
    if min(launches[k] for k in ("fb_forward", "fb_backward", "fb_combine")) == 0 or \
            any(launches[k] for k in ("gmm_score", "viterbi", "lstm_scan")):
        raise RuntimeError(f"the AED CLI twins did not go through K3 alone: {launches}")
    bpe = load_bpe(os.path.join(run_dir, "bpe.json"))
    fcfg = FrontendConfig()

    def load(chunk):
        m = A.build_aed_model(bpe.n_units, TrainConfig(nn_hidden=128, nn_layers=2), fcfg.feat_dim,
                              chunk_frames=chunk)
        m.load_state_dict({k: torch.as_tensor(v) for k, v in restore_checkpoint(ck)["params"].items()})
        return m.to(dev).eval()

    model, offline = load(8), load(0)
    utts = make_corpus(8, seed=7)
    batches = [pipe.live_rows(b) for b in pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg,
                                                         BatchConfig(), dev)]
    mismatch = []

    def words_of(m, fb, **kw):
        toks, n, _s = A.make_aed_decoder(m, **kw)(fb.feats, fb.n_frames)
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        return {uid: bpe.decode([int(t) for t in toks[b, : n[b]]]) for b, uid in enumerate(fb.utt_ids)}

    want_dec, want_eval = {}, {}
    for fb in batches:
        want_dec.update(words_of(model, fb, beam=4, max_tokens=64, ctc_weight=0.3))
        want_eval.update(words_of(offline, fb, beam=4, max_tokens=48))
    with open(os.path.join(work, "hyps.jsonl")) as f:
        if {r["utt_id"]: r["hyp"] for r in map(json.loads, f)} != want_dec:
            mismatch.append("decode")
    with open(os.path.join(work, "eval", "eval_hyps.jsonl")) as f:
        if {r["utt_id"]: r["hyp"] for r in map(json.loads, f)} != want_eval:
            mismatch.append("eval")
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    finals = [e for e in lines if "final" in e]

    def streamed(wave, event, sfcfg):
        fe = StreamingFrontend(sfcfg, device=dev)
        return np.concatenate([fe.process(wave[i:i + event]) for i in range(0, len(wave), event)] + [fe.finalize()])

    stream_fcfg = FrontendConfig(cmvn="sliding", cmvn_window=600)
    f = streamed(make_corpus(1, words_per_utt=(4, 6), seed=7)[0].wave, 4000, stream_fcfg)
    want = bpe.decode(A.aed_decode_batch(model, f[None], [f.shape[0]], beam=4, max_tokens=max(8, 2 + f.shape[0] // 4),
                                         ctc_weight=0.3)[0])
    if finals[0]["final"] != want:
        mismatch.append("stream")
    f = streamed(make_corpus(1, words_per_utt=(2, 3), seed=7)[0].wave, 4000, stream_fcfg)
    Tb = -(-f.shape[0] // 256) * 256
    padded = np.zeros((1, Tb, f.shape[1]), np.float32)
    padded[0, : f.shape[0]] = f
    want = bpe.decode(A.aed_decode_batch(model, padded, [f.shape[0]], beam=4, max_tokens=aed_final_max_tokens(Tb),
                                         ctc_weight=0.3)[0])
    if [e["final"] for e in finals[1:]] != [want]:
        mismatch.append("serve")
    gap = np.zeros(16000, np.float32)
    t_utts = make_corpus(4, words_per_utt=(2, 3), seed=5)
    wave = np.concatenate(sum(([u.wave, gap] for u in t_utts), [gap]))
    bounds = segment_utterances(wave, fcfg, VadConfig(max_segment_s=30.0))
    segs = {round(e["start_s"], 2): e["words"] for e in lines if "start_s" in e}
    want = {}
    for fb in pipe.featurize([(f"seg-{i:04d}", wave[a:b], []) for i, (a, b) in enumerate(bounds)], fcfg,
                             BatchConfig(bucket_boundaries=(500, 1000, 2000, 3010)), dev):
        for uid, seq in zip(fb.utt_ids, A.aed_decode_batch(model, fb.feats, fb.n_frames, beam=4, max_tokens=64,
                                                          ctc_weight=0.3)):
            want[round(bounds[int(uid.split("-")[1])][0] / fcfg.sample_rate, 2)] = bpe.decode(seq)
    if segs != want:
        mismatch.append("transcribe")
    if mismatch:
        raise RuntimeError(f"the AED CLI twins differ from the pipeline functions: {mismatch}")
    phase(61, f"the AED CLI twins in this process, {seconds:.1f} s: train_nn --objective aed (conformer 128 x 2, "
              f"--aed-chunk 8, 30 BPE merges, --mwer-steps 1), decode --aed --bpe, eval --aed --bpe, stream --aed, "
              f"transcribe --aed ({len(bounds)} segments) and serve --aed --engine, each equal to the pipeline "
              f"functions on the checkpoint's model; launches {launches}")
    return launches


DIST_BATCHES = 4         # phase 8's training batches in the data-parallel E-step and align step
DIST_NCCL_BATCHES = 2    # of them at world size 1 over NCCL
DIST_RANKS = 2
DIST_TIMEOUT_S = 600.0
DIST_STATS_ATOL = 2e-5   # tests/test_dist.py's, scaled to each statistic's magnitude as its :53-78 does
DIST_LOSS_RTOL, DIST_PARAM_ATOL = 1e-5, 2e-5
DIST_TRAIN_STEPS = 3     # the first at learning rate 0; the third's loss is taken after an update at lr(1)
DIST_GRAD_TOL = dict(rtol=1e-4, atol=2e-6)  # tests/test_torch_dist.py's, on 10 x AdamW's first moment


def nccl_in_process(fn, dev: torch.device, timeout_s: float, args):
    """``fn(0, mesh, *args)`` as numpy, in this process under a process group
    of one rank over NCCL: the card's collectives without a spawned process,
    which would pay again for its start and its first calls."""
    import datetime
    import tempfile

    import torch.distributed as tdist

    from mogasr_torch.config import MeshConfig
    from mogasr_torch.dist.launch import to_numpy
    from mogasr_torch.dist.mesh import make_mesh

    with tempfile.TemporaryDirectory(prefix="mogasr_nccl_") as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
                                 timeout=datetime.timedelta(seconds=timeout_s))
        try:
            return to_numpy(fn(0, make_mesh(MeshConfig(), dev), *args))
        finally:
            tdist.destroy_process_group()


def dist_phases(dev: torch.device, gmm, topo, tied, fcfg, dcfg, graph, corpus, bcfg, train_fbs) -> dict:
    """Phases 62-66: the multi-device steps (mogasr_torch.dist) on the card.
    One launch of DIST_RANKS gloo ranks (NCCL refuses two ranks on one card;
    every rank computes on cuda:0) runs every section, then this process,
    as one rank over NCCL, runs the data-parallel steps again. Phase 62: the data-parallel
    soft E-step and Viterbi align step on the headline bundle over
    DIST_BATCHES of phase 8's training batches, the decode step over the 768
    held-out utterances, 3 CE steps of LstmAm 1168 x 512 x 2 and 3 CTC steps
    of LstmAm 28 x 512 x 2 (phases 31 and 37's widths), each held to one
    process on the card; phase 63: the same steps at world size 1 over NCCL
    (DIST_NCCL_BATCHES batches, one decode batch), bitwise the local steps;
    phase 64: the tensor-parallel GMM score at the bundle's width, the states
    split over the 2 ranks, against one K1 call over all of them; phase 65:
    EP, SP and PP at the reference's dry-run shapes against one process, and
    the dry run's summary line; phase 66: ``graft_entry.entry()`` on the
    card against the plain chain. Returns the "dp" path's launches."""
    import copy

    from mogasr_torch import graft_entry
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import ctc, gmm_cuda
    from mogasr_torch.am.gmm import gmm_loglik
    from mogasr_torch.am.neural import build_model
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.train_nn import init_train_state, lr_schedule, make_train_step
    from mogasr_torch.config import DecodeConfig, TrainConfig
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.dist import cases, comm, launch
    from mogasr_torch.dist import pipeline_parallel as PP
    from mogasr_torch.frontend.torch_frontend import _deltas_batched, _masked_cmvn, make_frontend
    from mogasr_torch.dist.mesh import pad_to_multiple
    from mogasr_torch.eval.wer import corpus_wer
    from mogasr_torch.hmm import triphone as tri

    lex = topo.lexicon
    # the ranks get the GMM as contiguous arrays; the bundle's component-major
    # tensors sum their natural parameters in another order (scores 6e-5 apart),
    # so one process takes the same layout
    gmm = type(gmm)(*(a.contiguous() for a in gmm))
    S, K, D = gmm.means.shape
    gmm_np = tuple(a.cpu().numpy() for a in gmm)
    params = gmm_cuda.kernel_params(gmm, "float32")

    def align_fn(pids):
        return tri.align_graph_cd(tied, pids)

    def np_of(fb, graphs):
        return fb.feats.cpu().numpy(), fb.n_frames.cpu().numpy(), graphs

    def sync_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # ---- the inputs (numpy, whole batches) and one process's results on the card
    train = train_fbs[:DIST_BATCHES]
    train_np = [np_of(fb, pipe.build_align_graphs(fb.words, lex, topo, align_fn=align_fn)) for fb in train]
    held = pipe.featurize(corpus, fcfg, bcfg, dev)
    held_np = []
    for fb in held:
        feats, nf = fb.feats.cpu().numpy(), fb.n_frames.cpu().numpy()
        feats, _ = pad_to_multiple(feats, DIST_RANKS)
        nf, _ = pad_to_multiple(nf, DIST_RANKS)
        held_np.append((feats, nf, pipe.decode_graphs(graph, len(nf), dev)[0]))
    ce_fb = next(fb for fb in train_fbs if fb.feats.shape[1] <= NN_TRAIN_T)
    _, ce_labels, _ = pipe.align_batch(ce_fb, gmm, lex, topo, align_fn=align_fn, params=params)
    ctc_labels, ctc_nl = ctc.pack_label_batch([ctc.ctc_labels_from_words(lex, w) for w in ce_fb.words])
    ce_cfg = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=NN_LR, num_nn_steps=NN_STEPS)
    ctc_cfg = TrainConfig(nn_arch="lstm", nn_hidden=NN_HIDDEN, nn_layers=NN_LAYERS, lr=CTC_LR,
                          num_nn_steps=CTC_SCHEDULE)
    ce_model = init_(build_model("lstm", S, ce_cfg, D), torch.Generator().manual_seed(62))
    ctc_model = init_(build_model("lstm", lex.n_phones + 1, ctc_cfg, D), torch.Generator().manual_seed(63))
    ce_in = (ce_fb.feats.cpu().numpy(), ce_fb.n_frames.cpu().numpy(), ce_labels.cpu().numpy())
    ctc_in = (ce_in[0], ce_in[1], ctc_labels, ctc_nl)

    one = {}  # one process on the card: the same steps, no process group
    wall = {}
    # the GMM steps build K1's parameters from the GMM at each call, as the ranks' sharded steps do
    def soft_local(fb):
        return pipe.batch_stats(fb, gmm, lex, topo, "baum-welch", align_fn, S)[0]

    def align_local(feats, nf, graphs):
        ll = gmm_cuda.gmm_loglik_batched(torch.as_tensor(feats, device=dev), gmm, compute_dtype="float32", mode="sum")
        return viterbi_cuda.viterbi(ll, vit.graphs_to_torch(graphs, dev), torch.as_tensor(nf, device=dev))

    def per_batch(fn, items):
        timed_outs = [sync_wall(lambda: fn(x)) for x in items]
        return [t for t, _o in timed_outs], [o for _t, o in timed_outs]

    wall["soft"], one["soft"] = per_batch(soft_local, train)
    wall["align"], one["align"] = per_batch(lambda x: align_local(*x), train_np)
    wall["decode"], one["decode"] = per_batch(lambda x: align_local(*x), held_np)

    def local_train(model, cfg, step_fn, inputs):
        m = copy.deepcopy(model).to(dev)
        state = init_train_state(m, cfg)
        x = tuple(torch.as_tensor(a, device=dev) for a in inputs)
        out = {"metrics": [], "step_seconds": []}
        for i in range(DIST_TRAIN_STEPS):
            t, (state, met) = sync_wall(lambda: step_fn(state, *x))
            out["step_seconds"].append(t)
            out["metrics"].append(met)
            if i < 2:
                out[("first", "second")[i]] = {
                    "params": {k: v.detach().clone() for k, v in m.state_dict().items()},
                    "moments": {name: {k: state.opt.state[p][k].detach().clone() for k in ("exp_avg", "exp_avg_sq")}
                                for name, p in m.named_parameters() if p in state.opt.state}}
        out["params"] = {k: v.detach().clone() for k, v in m.state_dict().items()}
        return out

    one["ce"] = local_train(ce_model, ce_cfg, make_train_step(ce_cfg), ce_in)
    one["ctc"] = local_train(ctc_model, ctc_cfg, ctc.make_ctc_train_step(ctc_cfg), ctc_in)

    def dp_cases(n_train, n_held):
        c = {}
        for i, x in enumerate(train_np[:n_train]):
            c[f"soft_{i}"] = dict(kind="gmm", step="soft", gmm=gmm_np, inputs=x)
            c[f"align_{i}"] = dict(kind="gmm", step="align", gmm=gmm_np, inputs=x)
        for i, x in enumerate(held_np[:n_held]):
            c[f"decode_{i}"] = dict(kind="gmm", step="decode", gmm=gmm_np, inputs=x, acoustic_scale=dcfg.acoustic_scale)
        c["ce"] = dict(kind="train", factory="make_sharded_train_step", model=ce_model, cfg=ce_cfg, inputs=ce_in,
                       steps=DIST_TRAIN_STEPS)
        c["ctc"] = dict(kind="train", factory="make_sharded_ctc_train_step", model=ctc_model, cfg=ctc_cfg,
                        inputs=ctc_in, steps=DIST_TRAIN_STEPS)
        return c

    # the TP score: one training batch, the states split over the ranks (a 1 x DIST_RANKS mesh)
    tp_feats = train_np[0][0]
    k1_all = gmm_cuda.gmm_loglik_batched(torch.as_tensor(tp_feats, device=dev), gmm, compute_dtype="float32",
                                         mode="sum", params=params).cpu().numpy()
    # EP, SP and PP at the reference's dry-run shapes (one expert, time shard, stage a rank)
    rng = np.random.default_rng(65)
    moe_cfg = TrainConfig(nn_arch="moe", nn_hidden=8, nn_layers=2, nn_context=1, nn_experts=DIST_RANKS,
                          num_nn_steps=4)
    moe = init_(build_model("moe", 8, moe_cfg, 5), torch.Generator().manual_seed(12))
    x_ep = rng.standard_normal((DIST_RANKS, 6, 5)).astype(np.float32)
    nf_ep = np.full(DIST_RANKS, 6, np.int32)
    base_sp = rng.standard_normal((2, 8 * DIST_RANKS, 5)).astype(np.float32)
    nf_sp = np.asarray([8 * DIST_RANKS, 8 * DIST_RANKS - 5], np.int32)
    pp_params = {k: v.numpy() for k, v in PP.init_pp_params(torch.Generator().manual_seed(11), DIST_RANKS, 8,
                                                            8).items()}
    x_pp = rng.standard_normal((3, 4, 8)).astype(np.float32)
    par = dict(tp=dict(n_data=1, n_model=DIST_RANKS, score=[(gmm_np, tp_feats, "sum")]),
               ep=dict(am_forward=(moe, x_ep, nf_ep, 6)),
               sp=dict(tails=[(base_sp, nf_sp, True)]),
               pp=dict(forwards=[(pp_params, x_pp)]))

    t0 = time.perf_counter()
    ranks = launch.run_ranks(cases.sections, DIST_RANKS, device="cuda", timeout_s=DIST_TIMEOUT_S,
                             args=(dp_cases(DIST_BATCHES, len(held_np)), par, DIST_RANKS))
    gloo_s = time.perf_counter() - t0
    if launch.default_backend("cuda", DIST_RANKS) != "gloo" or launch.default_backend("cuda", 1) != "nccl":
        raise RuntimeError("the launcher chose another backend than gloo for 2 ranks and NCCL for 1 on one card")
    t0 = time.perf_counter()
    nccl = [nccl_in_process(cases.sections, dev, DIST_TIMEOUT_S, (dp_cases(DIST_NCCL_BATCHES, 1),))]
    nccl_s = time.perf_counter() - t0

    # ---- phase 62: data parallel, DIST_RANKS ranks over gloo
    dp = [r["dp"] for r in ranks]

    def check_stats(got_list, want_list, what):
        err = {}
        for field in ("occ", "sx", "sxx", "n_frames"):
            want = sum(getattr(s, field).double() for s in want_list).cpu().numpy()
            got = sum(getattr(g, field).astype(np.float64) for g in got_list)
            tol = DIST_STATS_ATOL * max(float(np.abs(want).max()), 1.0)
            err[field] = float(np.abs(got - want).max())
            if err[field] > tol:
                raise RuntimeError(f"{what}: {field} max |err| {err[field]:.3g} > {tol:.3g}")
        want_ll = float(sum(float(s.loglik) for s in want_list))
        got_ll = float(sum(float(g.loglik) for g in got_list))
        if abs(got_ll - want_ll) > 1e-5 * abs(want_ll):
            raise RuntimeError(f"{what}: loglik {got_ll} vs one process {want_ll}")
        return err

    n_soft = DIST_BATCHES
    for r in dp[1:]:
        if not launch.ranks_equal([[d[f"soft_{i}"]["stats"] for i in range(n_soft)] for d in (dp[0], r)]):
            raise RuntimeError("the data-parallel soft E-step's statistics differ between ranks")
    soft_err = check_stats([dp[0][f"soft_{i}"]["stats"] for i in range(n_soft)], one["soft"], "DP soft E-step")

    def check_paths(prefix, n, want, what):
        for i in range(n):
            path = np.concatenate([d[f"{prefix}_{i}"]["result"].path for d in dp])
            if not np.array_equal(path, want[i].path.cpu().numpy()):
                raise RuntimeError(f"{what} batch {i}: paths differ from one process")

    check_paths("align", n_soft, one["align"], "DP align")
    check_paths("decode", len(held_np), one["decode"], "DP decode")
    frames = sum(int(x[1].sum()) for x in held_np)
    if sum(dp[0][f"decode_{i}"]["totals"]["frames"] for i in range(len(held_np))) != frames:
        raise RuntimeError("DP decode: the summed frames differ from the batches'")
    hyps = []
    for i, (feats, nf, graphs_np) in enumerate(held_np):
        res = vit.ViterbiResult(*(torch.as_tensor(np.concatenate([getattr(d[f"decode_{i}"]["result"], f)
                                                                   for d in dp])) for f in ("path", "entered", "score")))
        toks = vit.path_to_tokens(res, graph.labels, graphs_np["chain_id"])[: held[i].size]
        hyps += [[t for t in seq if t not in pipe.DROP_TOKENS] for seq in toks]
    refs = [w for fb in held for w in fb.words[: fb.size]]
    want_hyps = []
    for i, fb in enumerate(held):
        toks = vit.path_to_tokens(one["decode"][i], graph.labels, held_np[i][2]["chain_id"])[: fb.size]
        want_hyps += [[t for t in seq if t not in pipe.DROP_TOKENS] for seq in toks]
    dp_wer, one_wer = corpus_wer(refs, hyps)[0], corpus_wer(refs, want_hyps)[0]
    if dp_wer != one_wer or len(hyps) != len(corpus):
        raise RuntimeError(f"DP decode WER {dp_wer} vs one process {one_wer} ({len(hyps)} utterances)")

    def check_train(name, cfg):
        """Every step's loss within DIST_LOSS_RTOL of one process's (the
        first two at the weights of the start, since lr(0) = 0; the third
        after the update at lr(1)). The global gradient: 10 x AdamW's first
        moment after the first step, and after the second its bias-corrected
        moments m / (1 - b1^2) and sqrt(v / (1 - b2^2)) (both steps see the
        same weights, so both are the gradient and its size), at
        DIST_GRAD_TOL. The parameters after the second step, the update at
        lr(1): Adam moves each entry by about lr(1) sign(g), so every entry
        whose gradient the gradient gate resolves (|g| past its atol and
        rtol) is held to DIST_PARAM_ATOL; an entry with |g| within the
        gradient's tolerance of 0 may take the other sign, is held to
        2 lr(1) + DIST_PARAM_ATOL and counted."""
        got, want = dp[0][name], one[name]
        if not launch.ranks_equal([d[name]["last"] for d in dp]):
            raise RuntimeError(f"DP {name}: parameters or AdamW moments differ between ranks")
        for s in range(DIST_TRAIN_STEPS):
            a, b = got["metrics"][s]["loss"], float(want["metrics"][s]["loss"])
            if abs(a - b) > DIST_LOSS_RTOL * abs(b):
                raise RuntimeError(f"DP {name} step {s}: loss {a} vs one process {b}")
        (b1, b2), lr1 = (0.9, 0.999), lr_schedule(cfg)(1)
        grad_err, params_err, past, unresolved, n = {"first": 0.0, "m": 0.0, "rms": 0.0}, 0.0, 0, 0, 0
        for k, w in want["second"]["moments"].items():
            g_first = 10 * got["first"]["moments"][k]["exp_avg"]
            g_m = got["second"]["moments"][k]["exp_avg"] / (1 - b1 ** 2)
            g_rms = np.sqrt(got["second"]["moments"][k]["exp_avg_sq"] / (1 - b2 ** 2))
            w_m = w["exp_avg"].cpu().numpy() / (1 - b1 ** 2)
            for what, gv, wv in (("first", g_first, 10 * want["first"]["moments"][k]["exp_avg"].cpu().numpy()),
                                 ("m", g_m, w_m),
                                 ("rms", g_rms, np.sqrt(w["exp_avg_sq"].cpu().numpy() / (1 - b2 ** 2)))):
                grad_err[what] = max(grad_err[what], float(np.abs(gv - wv).max()))
                if not np.allclose(gv, wv, **DIST_GRAD_TOL):
                    raise RuntimeError(f"DP {name}: the gradient ({what}) of {k} off the one process's by "
                                       f"{np.abs(gv - wv).max():.3g}")
            d = np.abs(got["second"]["params"][k] - want["second"]["params"][k].cpu().numpy())
            resolved = np.abs(w_m) * (1 - DIST_GRAD_TOL["rtol"]) > DIST_GRAD_TOL["atol"]
            params_err = max(params_err, float(d.max()))
            if (d[resolved] > DIST_PARAM_ATOL).any():
                raise RuntimeError(f"DP {name}: {k} after the update at lr(1): {int((d[resolved] > DIST_PARAM_ATOL).sum())}"
                                   f" entries with a resolved gradient past {DIST_PARAM_ATOL:g} (max "
                                   f"{d[resolved].max():.3g})")
            if (d > 2 * lr1 + DIST_PARAM_ATOL).any():
                raise RuntimeError(f"DP {name}: {k} after the update at lr(1) off by {d.max():.3g}")
            past += int((d > DIST_PARAM_ATOL).sum())
            unresolved += int((~resolved).sum())
            n += d.size
        return {"grad": grad_err, "params": params_err, "past_atol": past, "unresolved": unresolved, "n": n}

    ce_err, ctc_err = check_train("ce", ce_cfg), check_train("ctc", ctc_cfg)
    dp_launches = {}
    for d in dp:
        for case in d.values():
            for k, v in case["launches"].items():
                dp_launches[k] = dp_launches.get(k, 0) + v
    if min(dp_launches[k] for k in ("gmm_score", "viterbi", "fb_forward", "fb_backward", "fb_combine")) == 0:
        raise RuntimeError(f"the data-parallel path did not launch K1, K2 and K3 on the ranks: {dp_launches}")
    if sum(d[n]["launches"]["lstm_scan"] for d in dp for n in ("ce", "ctc")):
        raise RuntimeError("the data-parallel training steps launched K4 (they run the plain recurrence)")
    staged = sorted(comm.GLOO_STAGED)

    def warm_s(kind):
        """(the slowest rank's, one process's) seconds: the GMM steps' batches
        after the first, a training case's second step (a rank's first calls
        pay for its fresh process)."""
        if kind in ("ce", "ctc"):
            return max(d[kind]["step_seconds"][1] for d in dp), one[kind]["step_seconds"][1]
        n = len(wall[kind])
        return sum(max(d[f"{kind}_{i}"]["seconds"] for d in dp) for i in range(1, n)), sum(wall[kind][1:])

    phase(62, f"data parallel on {DIST_RANKS} ranks over gloo, every rank on cuda:0 (launch {gloo_s:.1f} s, all "
          f"sections; all-reduce and broadcast of CUDA tensors native, {', '.join(staged)} staged through pinned "
          f"host memory; one card: not an interconnect): soft E-step over {n_soft} training batches of {TRAIN_BATCH} "
          f"(K1 float32/sum, K3's chain arm) statistics within {DIST_STATS_ATOL:g} x magnitude of one process (max "
          f"|err| " + ", ".join(f"{k} {v:.3g}" for k, v in soft_err.items()) + "), ranks bitwise alike; align "
          f"(K1, K2's chain arm) paths bitwise; decode of the {len(corpus)} held-out utterances in {len(held_np)} "
          f"batches (K1 float32/sum, K2's word loop) paths bitwise, {frames} frames summed, WER {dp_wer:.4f} = one "
          f"process's; {DIST_TRAIN_STEPS} CE steps of LstmAm {S} x {NN_HIDDEN} x {NN_LAYERS - 1} on "
          f"B={len(ce_in[1])} T={ce_in[0].shape[1]} and {DIST_TRAIN_STEPS} CTC steps of LstmAm {lex.n_phones + 1} x "
          f"{NN_HIDDEN} x {NN_LAYERS - 1} (K3 on the ranks): every step's loss within rtol {DIST_LOSS_RTOL:g} of one "
          f"process's (the last after the update at lr(1)), the gradients (rtol {DIST_GRAD_TOL['rtol']:g}, atol "
          f"{DIST_GRAD_TOL['atol']:g}; 10 x AdamW's first moment after the first step, the bias-corrected moments "
          f"m and sqrt(v) after the second) max |err| CE " + ", ".join(f"{k} {v:.3g}" for k, v in ce_err["grad"].items())
          + ", CTC " + ", ".join(f"{k} {v:.3g}" for k, v in ctc_err["grad"].items()) + f"; the parameters after the "
          f"update at lr(1): entries with a resolved gradient within {DIST_PARAM_ATOL:g}, max |err| CE "
          f"{ce_err['params']:.3g} ({ce_err['past_atol']} of {ce_err['n']} past {DIST_PARAM_ATOL:g}, "
          f"{ce_err['unresolved']} with |g| within the gradient's tolerance of 0), CTC {ctc_err['params']:.3g} "
          f"({ctc_err['past_atol']} of {ctc_err['n']} past, {ctc_err['unresolved']} unresolved); "
          f"AdamW's states bitwise alike on both ranks, K4 never launched in training; launches on the ranks "
          f"{dp_launches}; seconds, {DIST_RANKS} ranks (the slowest) vs one process, warm (the GMM steps' batches "
          f"after the first, the training steps' second step): "
          + ", ".join("{} {:.3f} vs {:.3f}".format(k, *warm_s(k)) for k in ("soft", "align", "decode", "ce", "ctc"))
          + f"; the first CE step on a rank {max(d['ce']['step_seconds'][0] for d in dp):.2f} s")

    # ---- phase 63: world size 1 over NCCL, bitwise the local steps
    solo = nccl[0]["dp"]
    for i in range(DIST_NCCL_BATCHES):
        got, want = solo[f"soft_{i}"]["stats"], one["soft"][i]
        for field in ("occ", "sx", "sxx", "loglik", "n_frames"):
            if not np.array_equal(np.asarray(getattr(got, field)), getattr(want, field).cpu().numpy()):
                raise RuntimeError(f"NCCL world size 1: soft E-step {field} of batch {i} not bitwise the local step")
        if not np.array_equal(solo[f"align_{i}"]["result"].path, one["align"][i].path.cpu().numpy()):
            raise RuntimeError(f"NCCL world size 1: align batch {i} not bitwise")
    if not np.array_equal(solo["decode_0"]["result"].score, one["decode"][0].score.cpu().numpy()):
        raise RuntimeError("NCCL world size 1: decode scores not bitwise")
    for name in ("ce", "ctc"):
        for s in range(DIST_TRAIN_STEPS):
            if solo[name]["metrics"][s]["loss"] != float(one[name]["metrics"][s]["loss"]):
                raise RuntimeError(f"NCCL world size 1: {name} step {s} loss not bitwise the local step")
        if any(not np.array_equal(solo[name]["last"]["params"][k], v.cpu().numpy())
               for k, v in one[name]["params"].items()):
            raise RuntimeError(f"NCCL world size 1: {name} parameters not bitwise the local step")
    phase(63, f"world size 1 over NCCL, in this process ({nccl_s:.1f} s): the soft E-step and align on {DIST_NCCL_BATCHES} "
          f"training batches, the decode of one held-out batch, {DIST_TRAIN_STEPS} CE and {DIST_TRAIN_STEPS} CTC steps "
          f"bitwise equal to one process's "
          f"local steps")

    # ---- phase 64: the TP GMM score, states split over the ranks
    got = ranks[0]["par"]["tp"]["score"][0]
    tp_err = float(np.abs(got - k1_all).max())
    tp_bitwise = np.array_equal(got, k1_all)
    if not tp_bitwise and tp_err > K1_ATOL:
        raise RuntimeError(f"TP score: max |err| {tp_err} from one K1 call over all {S} states")
    phase(64, f"tensor-parallel GMM score at the bundle's width ({S} states split {S // DIST_RANKS} + "
          f"{S - S // DIST_RANKS} over {DIST_RANKS} ranks, K1 float32/sum on each, all-gathered): "
          + ("bitwise equal to one K1 call over all states" if tp_bitwise else
             f"max |err| {tp_err:.3g} from one K1 call over all states (K1's state tiles start at each block's "
             f"first state)") + f" on B={tp_feats.shape[0]} T={tp_feats.shape[1]}")

    # ---- phase 65: EP, SP and PP at the dry-run shapes, and the dry run itself
    par_out = ranks[0]["par"]
    with torch.no_grad():
        dense = moe.to(dev)(torch.as_tensor(x_ep, device=dev), torch.as_tensor(nf_ep, device=dev)).cpu().numpy()
        base_t, nf_t = torch.as_tensor(base_sp, device=dev), torch.as_tensor(nf_sp, device=dev)
        feats_sp, prev = [base_t], base_t
        for _ in range(2):
            prev = _deltas_batched(prev, nf_t, 2)
            feats_sp.append(prev)
        mask = (torch.arange(base_t.shape[1], device=dev)[None, :] < nf_t[:, None]).float()
        tail = _masked_cmvn(torch.cat(feats_sp, dim=-1), mask, True).cpu().numpy()
        serial = PP.serial_forward({k: torch.as_tensor(v, device=dev) for k, v in pp_params.items()},
                                   torch.as_tensor(x_pp, device=dev).reshape(-1, 8)).reshape(3, 4, -1).cpu().numpy()
    errs = {"ep": float(np.abs(par_out["ep"]["am_forward"] - dense).max()),
            "sp": float(np.abs(par_out["sp"]["tails"][0] - tail).max()),
            "pp": float(np.abs(par_out["pp"]["forwards"][0] - serial).max())}
    for k, tol in (("ep", 2e-5), ("sp", 1e-4), ("pp", 1e-5)):
        if errs[k] > tol:
            raise RuntimeError(f"{k.upper()} on the card: max |err| {errs[k]:.3g} from one process > {tol}")
    summary = graft_entry.dryrun_summary(DIST_RANKS, ranks[0]["dryrun"])
    print(summary, flush=True)
    phase(65, f"EP (MoeAm, one expert a rank, all-to-all), SP (the delta/CMVN tail, time-sharded) and PP (GPipe, 3 "
          f"microbatches) at the dry-run shapes on the card, max |err| from one process: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; the dry run's line printed above; its launches "
          f"on rank 0 {ranks[0]['dryrun']['launches']}")

    # ---- phase 66: entry() on the card
    zero_launches()
    fn, example = graft_entry.entry()
    entry_s, (path, score) = sync_wall(lambda: fn(*example))
    entry_launches = launch_counts()
    require_k1_k2_only("entry()", entry_launches)
    fcfg_e, lex_e, topo_e, batch_e = graft_entry._build_setup()
    gmm_e = type(gmm)(*(torch.as_tensor(a, device=dev) for a in graft_entry.headline_gmm(D=fcfg_e.feat_dim)))
    with torch.no_grad():
        feats_e, nf_e = make_frontend(fcfg_e, batch_e.waves.shape[1], dev)(
            torch.as_tensor(batch_e.waves, device=dev), torch.as_tensor(batch_e.num_samples, device=dev))
        B_e, T_e, D_e = feats_e.shape
        ll_e = gmm_loglik(feats_e.reshape(B_e * T_e, D_e), gmm_e).reshape(B_e, T_e, -1)
        plain = vit.viterbi(ll_e, pipe.decode_graphs(pipe.word_decode_graph(lex_e, topo_e, DecodeConfig()), B_e,
                                                     dev)[1], nf_e, acoustic_scale=DecodeConfig().acoustic_scale)
    agree = float((path == plain.path).float().mean())
    score_rel = float(((score - plain.score).abs() / plain.score.abs()).max())
    if not bool(torch.isfinite(score).all()) or agree < MIN_AGREEMENT or score_rel > 1e-5:
        raise RuntimeError(f"entry(): frames agreeing with the plain chain {agree:.4f}, score rel err {score_rel:.3g}")
    phase(66, f"graft_entry.entry() on the card: B={B_e} T={T_e}, GMM 1000 x 256 x {D_e} with K1 float32/sum, K2 over "
          f"the word loop, {1e3 * entry_s:.1f} ms; launches {entry_launches}; frames agreeing with the plain chain "
          f"{agree:.4f}, score rel err {score_rel:.3g}")
    keys = ("gmm_score", "viterbi", "fb_forward", "fb_backward", "fb_combine")
    return {"dp": {k: dp_launches[k] for k in keys}, "entry": entry_launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card")

    from mogasr_torch import _cuda
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda
    from mogasr_torch.am.gmm import gmm_loglik
    from mogasr_torch.config import BatchConfig, DecodeConfig, GmmConfig, TrainConfig
    from mogasr_torch.data.batching import make_batches
    from mogasr_torch.decoder import fb_cuda
    from mogasr_torch.decoder import forward_backward as fbd
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.frontend.numpy_ref import extract_features_np
    from mogasr_torch.frontend.torch_frontend import make_frontend
    from mogasr_torch.hmm import triphone as tri
    from mogasr_torch.recipes.decode_held_out import held_out_utterances
    from mogasr_torch.utils.bundle import load_system

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_exps_per_s = SFU_EXPS_PER_SM_CLOCK * n_sms * sm_mhz * 1e6
    phase(0, f"device {kind!r}; nvidia-smi: {smi}, max SM clock {sm_mhz:g} MHz, {n_sms} SMs; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase(1, f"built mogasr_torch/csrc kernels in {_cuda.build_all():.1f} s")

    gmm, topo, fcfg, tied, meta = load_system(BUNDLE, dev)
    S, K, D = gmm.means.shape
    rng = np.random.default_rng(0)
    dmeta = meta.get("decode", {})
    dcfg = DecodeConfig(acoustic_scale=dmeta.get("acoustic_scale", 1.0),
                        word_insertion_penalty=dmeta.get("word_insertion_penalty", 2.0))
    graph = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    J = graph.n_states
    held_out = held_out_utterances(topo, meta, 768)
    corpus = [(u.utt_id, u.wave, u.words) for u in held_out]
    bcfg = BatchConfig(batch_size=256, bucket_boundaries=(250, 350, 450, 600))
    # the decode path's widest batch: 256 rows x 600 frames, ragged n_frames
    batch = max(make_batches(corpus, bcfg, fcfg), key=lambda b: b.waves.shape[1])
    fb = pipe.featurize_batch(batch, make_frontend(fcfg, batch.waves.shape[1], dev), dev)
    B, T, _ = fb.feats.shape

    # ---- phase 2: K1 against its plain version
    def k1_bound_of(n, dt, mode):
        return k1_bound(n, S, K, D, dt, mode, sfu_exps_per_s)

    def k1(x, dt, mode):
        return gmm_cuda.gmm_loglik_fused(x, gmm, dt, mode, params=params[dt])

    def k1_plain(x, dt, mode):
        return gmm_loglik(x, gmm, mode=mode, compute_dtype=dt)

    params = {dt: gmm_cuda.kernel_params(gmm, dt) for dt in ("float32", "bfloat16")}
    x_main = fb.feats.reshape(B * T, D)
    main_name = f"decode-path batch N={B * T}"
    inputs = {
        "random N=8192": torch.as_tensor(rng.standard_normal((8192, D)).astype(np.float32), device=dev),
        main_name: x_main,
    }
    k1_ms, k1_err, k1_bounds = {}, {}, {}
    for name, x in inputs.items():
        for dt in ("float32", "bfloat16"):
            for mode in ("sum", "max"):
                if x is x_main and (dt, mode) in K1_TIMED:
                    ms, got = timed(lambda: k1(x, dt, mode), 5)
                    plain_ms, want = timed(lambda: k1_plain(x, dt, mode), 3)
                    k1_ms[(dt, mode)] = (ms, plain_ms)
                    k1_bounds[(dt, mode)] = k1_bound_of(x.shape[0], dt, mode)
                else:
                    got, want = k1(x, dt, mode), k1_plain(x, dt, mode)
                torch.cuda.synchronize()
                if got.shape != (x.shape[0], S) or not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"K1 {dt}/{mode} on {name}: bad output {tuple(got.shape)}")
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL):
                    raise RuntimeError(f"K1 {dt}/{mode} on {name} disagrees with the plain scorer: "
                                       f"max |err| {err}")
                k1_err[(name, dt, mode)] = err
    if gmm_cuda.LAUNCHES == 0:
        raise RuntimeError("K1 was never launched")
    phase(2, "K1 matches plain (atol %g rtol %g), max |err|: %s; at N=%d %s" % (
        K1_ATOL, K1_RTOL, ", ".join(f"{n} {d}/{m} {e:.3g}" for (n, d, m), e in k1_err.items()), B * T,
        "; ".join(f"{d}/{m} {k1_ms[(d, m)][0]:.3f} ms (plain {k1_ms[(d, m)][1]:.3f} ms, bound "
                  f"{k1_bounds[(d, m)][0]:.3f} ms by {k1_bounds[(d, m)][1]}: "
                  + ", ".join(f"{w} {t:.3f}" for w, t in k1_bounds[(d, m)][2].items()) + ")"
                  for d, m in K1_TIMED)))

    # ---- phase 3: K2 against its plain version, bitwise
    ll_main = k1(x_main, "bfloat16", "max").reshape(B, T, S)
    _, graphs_main = pipe.decode_graphs(graph, B, dev)
    _, graphs16 = pipe.decode_graphs(graph, 16, dev)
    ll16 = torch.as_tensor((rng.standard_normal((16, T, S)) * 4 - 20).astype(np.float32), device=dev)
    nf16 = torch.as_tensor(np.r_[T, rng.integers(1, T, 14), 0].astype(np.int32), device=dev)
    cases = {
        f"decode-path batch B={B} T={T}, scale {dcfg.acoustic_scale:g}": (
            ll_main, graphs_main, fb.n_frames, dcfg.acoustic_scale),
        "random emissions B=16, scale 0.7": (ll16, graphs16, nf16, 0.7),
        "the same with skip transitions": (ll16, with_chain_skips(graphs16), nf16, 0.7),
    }
    k2_err = 0.0
    arm_names_k2 = {viterbi_cuda.ARM_CHAIN: "chain", viterbi_cuda.ARM_LOOP: "word loop",
                    viterbi_cuda.ARM_BLOCK: "block"}
    for name, (ll, graphs, nf, scale) in cases.items():
        if ll is ll_main:
            k2_ms, got = timed(lambda: viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale), 5)
            k2_main_arms = sorted({arm_names_k2[a] for a in viterbi_cuda.LAST_ARMS.tolist()})
            k2_plain_ms, want = timed(lambda: vit.viterbi(ll, graphs, nf, acoustic_scale=scale), 2)
        else:
            got = viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale)
            want = vit.viterbi(ll, graphs, nf, acoustic_scale=scale)
        torch.cuda.synchronize()
        for field in ("path", "entered", "score"):
            a, b = getattr(got, field), getattr(want, field)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise RuntimeError(f"K2 ({name}): {field} differs from the plain Viterbi")
        if ll is ll_main:
            k2_err = float((got.score - want.score).abs().max())
    if viterbi_cuda.LAUNCHES == 0:
        raise RuntimeError("K2 was never launched")
    k2_main_bound = k2_bound(graphs_main, fb.n_frames, T)
    # K3's device times on this batch, for phase 20 (confidence runs K3 on
    # the same batch): profiled here, early in the run, as a profiling window
    # late in it has come back without the kernels' device activity
    fb_names = ("fb_forward_kernel", "fb_backward_kernel", "fb_combine_kernel")
    k3_decode_dev = {"shape": (B, T), "device_ms": kernel_device_ms(lambda: fb_cuda.forward_backward(
        ll_main, graphs_main, fb.n_frames, acoustic_scale=dcfg.acoustic_scale), fb_names, 3)}
    phase(3, f"K2 bitwise equal to plain on J={J}: {'; '.join(cases)}; decode-path batch "
          f"({int((fb.n_frames > 0).sum())} rows with frames, {int(fb.n_frames.sum())} frames) "
          f"{k2_ms:.3f} ms (plain {k2_plain_ms:.3f} ms, bound {k2_main_bound[0]:.4f} ms by {k2_main_bound[1]}; "
          f"arm {'+'.join(k2_main_arms)})")
    del ll_main, cases, got, want

    # ---- phase 4: front end on the card against the NumPy oracle
    fe_err = 0.0
    for utt_id, wave, _words in corpus[:4]:
        fe = make_frontend(fcfg, len(wave), dev)
        feats, nf = fe(torch.as_tensor(wave)[None], torch.as_tensor([len(wave)]))
        got = feats[0, : int(nf[0])].cpu().numpy()
        want = extract_features_np(wave, fcfg)
        if got.shape != want.shape:
            raise RuntimeError(f"front end {utt_id}: shape {got.shape} vs oracle {want.shape}")
        fe_err = max(fe_err, float(np.abs(got - want).max()))
    if fe_err > FRONTEND_ATOL:
        raise RuntimeError(f"front end disagrees with the NumPy oracle: max |err| {fe_err}")
    phase(4, f"front end matches numpy_ref on 4 utterances: max |err| {fe_err:.3g} (atol {FRONTEND_ATOL})")

    # ---- phase 5: the decode path, one warm pass, then a timed pass
    def decode_path(g):
        return pipe.decode_corpus(corpus, g, graph, fcfg, dcfg, bcfg, dev, compute_dtype="bfloat16")

    decode_path(gmm)
    gmm_cuda.LAUNCHES = 0
    viterbi_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    run = decode_path(gmm)
    decode_launches = {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES}
    if min(decode_launches.values()) == 0:
        raise RuntimeError(f"the decode path did not go through every kernel: {decode_launches}")
    if run.n_utts != len(corpus) or not np.isfinite(run.scores).all():
        raise RuntimeError(f"decode path decoded {run.n_utts} of {len(corpus)} utterances, "
                           f"finite scores: {bool(np.isfinite(run.scores).all())}")
    if run.wer > MAX_WER:
        raise RuntimeError(f"decode path WER {run.wer:.4f} > {MAX_WER}")
    stages = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in run.stage_seconds.items())
    phase(5, f"decode path: {run.n_utts} utts, WER {run.wer:.4f}, {run.n_utts / run.seconds:.1f} utt/s, "
          f"RTF {run.seconds / run.audio_seconds:.6f} ({run.seconds:.3f} s for "
          f"{run.audio_seconds:.1f} s of audio); stage ms: {stages}; launches {decode_launches}")

    # ---- phase 6: the plain float32 path on the card
    plain = pipe.decode_corpus(corpus, gmm, graph, fcfg, dcfg, bcfg, dev,
                               compute_dtype="float32", use_kernels=False)
    same = sum(a == b for a, b in zip(run.hyps, plain.hyps)) / len(run.hyps)
    if same < MIN_AGREEMENT:
        raise RuntimeError(f"kernel path agrees with the plain f32 path on {same:.4f} of utterances")
    phase(6, f"plain f32 path: WER {plain.wer:.4f}; transcripts identical to the kernel path "
          f"on {same:.4f} of {len(run.hyps)} utterances")
    k1_hyps, plain_wer = run.hyps, plain.wer
    del fb, plain

    # ---- phase 7: K3f/K3b against the plain forward-backward
    train_corpus, train_fbs, fbw, synth_s, train_speakers = training_batches(topo, fcfg, dev)
    Bw, Tw, _ = fbw.feats.shape

    def align_fn(pids):
        return tri.align_graph_cd(tied, pids)

    graphs_w = vit.graphs_to_torch(pipe.build_align_graphs(fbw.words, topo.lexicon, topo, align_fn=align_fn), dev)
    Jw = graphs_w["emit_id"].shape[1]
    x_w = fbw.feats.reshape(Bw * Tw, D)
    k1_train_ms, ll_w = timed(lambda: k1(x_w, "float32", "sum"), 5)
    k1_train_plain_ms, ll_w_plain = timed(lambda: k1_plain(x_w, "float32", "sum"), 3)
    k1_train_err = float((ll_w - ll_w_plain).abs().max())
    if not torch.allclose(ll_w, ll_w_plain, atol=K1_ATOL, rtol=K1_RTOL):
        raise RuntimeError(f"K1 float32/sum on the training batch disagrees with plain: max |err| {k1_train_err}")
    k1_train_bound = k1_bound_of(Bw * Tw, "float32", "sum")
    ll_w = ll_w.reshape(Bw, Tw, S)
    del ll_w_plain
    n_rand = 8
    nf_rand = torch.as_tensor(np.r_[Tw, 1, 0, rng.integers(2, Tw, n_rand - 3)].astype(np.int32), device=dev)
    ll_rand = torch.as_tensor((rng.standard_normal((n_rand, Tw, S)) * 4 - 20).astype(np.float32), device=dev)
    graphs_rand = {k: v[:n_rand].contiguous() for k, v in graphs_w.items()}
    # the general arm: phase 3's word loop (a loop arc in every row) at the
    # training batch's shape, random emissions, ragged n_frames
    _, graphs_loop = pipe.decode_graphs(graph, Bw, dev)
    nf_loop = torch.as_tensor(np.r_[Tw, 1, 0, rng.integers(2, Tw, Bw - 3)].astype(np.int32), device=dev)
    ll_loop = torch.as_tensor((rng.standard_normal((Bw, Tw, S)) * 4 - 20).astype(np.float32), device=dev)
    train_name = f"training batch B={Bw} T={Tw} J={Jw}"
    loop_name = f"word loop B={Bw} T={Tw} J={J}"
    fb_cases = {
        train_name: (ll_w, graphs_w, fbw.n_frames),
        f"random emissions B={n_rand} n_frames {nf_rand.tolist()}": (ll_rand, graphs_rand, nf_rand),
        "the same with skip transitions": (ll_rand, with_chain_skips(graphs_rand), nf_rand),
        loop_name: (ll_loop, graphs_loop, nf_loop),
    }
    arm_names = {fb_cuda.ARM_CHAIN: "chain", fb_cuda.ARM_BLOCK: "block", fb_cuda.ARM_GENERAL: "general"}
    fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = 0
    fb_line, fb_timed, fb_arms = [], {}, {}
    for name, (ll, graphs, nf) in fb_cases.items():
        if name in (train_name, loop_name):
            pair_ms = per_call_ms(lambda: fb_cuda.forward_backward(ll, graphs, nf), 20)
            kernel_ms = kernel_device_ms(lambda: fb_cuda.forward_backward(ll, graphs, nf), fb_names, 5)
            pair_one_ms, got = timed(lambda: fb_cuda.forward_backward(ll, graphs, nf), 5)
            emit_graph = fbd.gather_emissions(ll, graphs["emit_id"], 1.0)
            plain_fwd_ms, (alphas, loglik) = timed(lambda: fbd.forward_pass(emit_graph, graphs, nf), 2)
            plain_bwd_ms, log_gamma = timed(lambda: fbd.backward_pass(emit_graph, graphs, nf, alphas, loglik), 2)
            want = fbd.FBResult(log_gamma, loglik)
            fb_timed[name] = {"pair_ms": pair_ms, "pair_one_call_ms": pair_one_ms, **kernel_ms,
                              "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
                              "bounds": fb_bounds(graphs, nf, Tw)}
            del emit_graph, alphas
        else:
            got = fb_cuda.forward_backward(ll, graphs, nf)
            want = fbd.forward_backward(ll, graphs, nf)
        arms = fb_cuda.LAST_ARMS.tolist()
        want64 = fbd.forward_backward(ll.double(), graphs, nf)
        torch.cuda.synchronize()
        if got.log_gamma.shape != want.log_gamma.shape or not bool(torch.isfinite(got.loglik).all()):
            raise RuntimeError(f"K3 ({name}): bad output {tuple(got.log_gamma.shape)}")
        ll_err = float((got.loglik - want.loglik).abs().max())
        ll_rel64 = float(((got.loglik.double() - want64.loglik) / want64.loglik.abs()).abs().max())
        if not torch.allclose(got.loglik, want.loglik, rtol=FB_LOGLIK_RTOL, atol=0.0) or ll_rel64 > FB_LOGLIK_RTOL:
            raise RuntimeError(f"K3f ({name}): loglik off by {ll_err} from plain f32, rel {ll_rel64:.3g} from f64")
        post = fbd.state_posteriors_to_pdf(got.log_gamma, graphs["emit_id"], S)
        post32 = fbd.state_posteriors_to_pdf(want.log_gamma, graphs["emit_id"], S)
        post64 = fbd.state_posteriors_to_pdf(want64.log_gamma, graphs["emit_id"], S)
        # a row whose frames cannot reach its final state has loglik ~ NEG_INF:
        # its float32 posteriors are artifacts of -1e30 arithmetic, the same in
        # the kernels and the plain version, and differ from float64's
        ok = want64.loglik > fbd.NEG_INF / 2
        err64 = float((post[ok].double() - post64[ok]).abs().max())
        err32_64 = float((post32[ok].double() - post64[ok]).abs().max())
        err32 = float((post - post32).abs().max())
        if ((err32 > FB_POST_ATOL and name != loop_name) or err64 > FB_POST64_ATOL
                or err64 > max(FB_ERR_RATIO * err32_64, FB_ERR_FLOOR)):
            raise RuntimeError(f"K3b ({name}): pdf posteriors {err32:.3g} from plain f32, {err64:.3g} from "
                               f"f64 (plain f32: {err32_64:.3g}); limits {FB_POST_ATOL} from plain f32, "
                               f"{FB_POST64_ATOL} and {FB_ERR_RATIO}x plain f32's from f64")
        masked = torch.arange(Tw, device=dev)[None, :] >= nf[:, None]
        if not bool((got.log_gamma[masked] == fbd.NEG_INF).all()):
            raise RuntimeError(f"K3b ({name}): log_gamma is not NEG_INF on padded frames")
        if arms[0] != arms[1]:
            raise RuntimeError(f"K3 ({name}): K3f and K3b took different arms {arms}")
        fb_arms[name] = sorted({arm_names[a] for a in arms[0]})
        if name in fb_timed:
            fb_timed[name].update(ll_err=ll_err, post_err=err32, arm="+".join(fb_arms[name]))
        fb_line.append(f"{name}: arm K3f/K3b {'+'.join(fb_arms[name])}; loglik max |err| {ll_err:.3g} vs plain "
                       f"f32, max rel {ll_rel64:.3g} vs f64; pdf posteriors max |err| {err32:.3g} vs plain f32, "
                       f"{err64:.3g} vs f64 (plain f32 vs f64 {err32_64:.3g}; {int(ok.sum())} of {len(ok)} rows "
                       f"reach their final state)")
        del got, want, want64, post, post32, post64
    fb_phase_launches = (fb_cuda.FWD_LAUNCHES, fb_cuda.BWD_LAUNCHES, fb_cuda.COMBINE_LAUNCHES)
    if min(fb_phase_launches) == 0:
        raise RuntimeError("K3f/K3b were never launched")
    if fb_arms[train_name] != ["chain"] or fb_arms[loop_name] != ["general"]:
        raise RuntimeError(f"K3 arms: training batch {fb_arms[train_name]}, word loop {fb_arms[loop_name]}")

    def fb_text(name):
        r = fb_timed[name]
        bd = r["bounds"]
        return (f"{name} ({r['arm']} arm): K3f + K3b + combine {r['pair_ms']:.3f} ms a call in a run of 20 "
                f"({r['pair_one_call_ms']:.3f} ms for one call alone, host included; bound {bd['pair'][0]:.4f} ms "
                f"by {bd['pair'][1]}); K3f {r['fb_forward_kernel']:.3f} ms (bound {bd['fwd'][0]:.4f} ms by "
                f"{bd['fwd'][1]}), K3b {r['fb_backward_kernel']:.3f} ms (bound {bd['bwd'][0]:.4f} ms by "
                f"{bd['bwd'][1]}), combine {r['fb_combine_kernel']:.3f} ms (bound {bd['combine'][0]:.4f} ms by "
                f"{bd['combine'][1]}); plain forward {r['plain_fwd_ms']:.3f} ms, backward {r['plain_bwd_ms']:.3f} ms")

    phase(7, "K3f/K3b match plain (loglik rtol %g; posteriors within %g of plain f32 (but on the word loop), "
          "within %g of f64 and %gx plain f32's error): %s; timed: %s; launches K3f %d, K3b %d, combine %d; "
          "the training batch's K1 float32/sum emissions (N=%d) %.3f ms (plain %.3f ms, max |err| %.3g; "
          "bound %.3f ms by %s: %s)" % (
              FB_LOGLIK_RTOL, FB_POST_ATOL, FB_POST64_ATOL, FB_ERR_RATIO, "; ".join(fb_line),
              "; ".join(fb_text(n) for n in (train_name, loop_name)), *fb_phase_launches, Bw * Tw, k1_train_ms,
              k1_train_plain_ms, k1_train_err, *k1_train_bound[:2],
              ", ".join(f"{w} {t:.3f}" for w, t in k1_train_bound[2].items())))
    fb_train, fb_loop = fb_timed[train_name], fb_timed[loop_name]

    # K2 on the same batch's align graphs and K1 emissions: the traffic of Viterbi EM
    k2_align, line = {}, []
    for name, graphs in {"align graphs": graphs_w, "with skip transitions": with_chain_skips(graphs_w)}.items():
        r = k2_align_times(ll_w, graphs, fbw.n_frames)
        arms = sorted({arm_names_k2[a] for a in viterbi_cuda.LAST_ARMS.tolist()})
        bd = k2_bound(graphs, fbw.n_frames, Tw)
        k2_align[name] = {"arm": "+".join(arms), **r, "bound_ms": bd[0], "bound_by": bd[1]}
        line.append(f"{name}: arm {'+'.join(arms)}, K2 {r['ms']:.4f} ms on the device, {r['run_ms']:.4f} ms a call "
                    f"in a run of 20, {r['call_ms']:.4f} ms one call (plain {r['plain_ms']:.3f} ms, bound {bd[0]:.4f} "
                    f"ms by {bd[1]})")
    if k2_align["align graphs"]["arm"] != "chain":
        raise RuntimeError(f"K2 on the align graphs took the {k2_align['align graphs']['arm']} arm, not the chain arm")
    k2_align = {**k2_align.pop("align graphs"), "with_skips": k2_align["with skip transitions"]}
    phase(7, f"K2 bitwise equal to plain on the {train_name} with its K1 float32/sum emissions: " + "; ".join(line))
    del ll_w, ll_rand, ll_loop

    # ---- phase 8: the training path
    gcfg = GmmConfig(n_states=S, n_components=K, feat_dim=D, var_floor=meta["var_floor"],
                     min_split_occ=meta["min_split_occ"])
    n_train_frames = sum(int(f.n_frames.sum()) for f in train_fbs)
    gmm_cuda.LAUNCHES = viterbi_cuda.LAUNCHES = 0
    fb_cuda.FWD_LAUNCHES = fb_cuda.BWD_LAUNCHES = fb_cuda.COMBINE_LAUNCHES = 0
    torch.cuda.synchronize()
    bw = pipe.train_gmm(train_fbs, topo.lexicon, topo, gcfg, TrainConfig(num_em_iters=2), gmm=gmm,
                        mode="baum-welch", align_fn=align_fn, n_pdfs=S)
    vt = pipe.train_gmm(train_fbs, topo.lexicon, topo, gcfg, TrainConfig(num_em_iters=1), gmm=bw.gmm,
                        mode="viterbi", align_fn=align_fn, n_pdfs=S)
    torch.cuda.synchronize()
    train_launches = {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES,
                      "fb_forward": fb_cuda.FWD_LAUNCHES, "fb_backward": fb_cuda.BWD_LAUNCHES,
                      "fb_combine": fb_cuda.COMBINE_LAUNCHES}
    if min(train_launches.values()) == 0:
        raise RuntimeError(f"the training path did not go through every kernel: {train_launches}")
    history = bw.history + vt.history
    if not np.isfinite(history).all() or bw.history[1] < bw.history[0] - BW_MAX_DROP:
        raise RuntimeError(f"EM log-likelihood per frame {history}: not finite, or Baum-Welch fell "
                           f"by more than {BW_MAX_DROP}")
    trained = vt.gmm
    if not all(bool(torch.isfinite(a).all()) for a in trained) or trained.means.shape != (S, K, D):
        raise RuntimeError(f"re-estimated GMM: shape {tuple(trained.means.shape)} or values not finite")
    dec = decode_path(trained)
    if dec.wer > MAX_WER:
        raise RuntimeError(f"held-out WER of the re-estimated GMM {dec.wer:.4f} > {MAX_WER}")
    # one Baum-Welch E-step on the widest batch: kernel path vs plain path
    stats_k, _, _ = pipe.batch_stats(fbw, gmm, topo.lexicon, topo, "baum-welch", align_fn, S,
                                     params=gmm_cuda.kernel_params(gmm, "float32"))
    stats_p, _, _ = pipe.batch_stats(fbw, gmm, topo.lexicon, topo, "baum-welch", align_fn, S,
                                     use_kernels=False)
    stats_err = {}
    for field in ("occ", "sx", "sxx"):
        a, b = getattr(stats_k, field), getattr(stats_p, field)
        stats_err[field] = float((a - b).abs().max() / b.abs().max())
        if stats_err[field] > STATS_TOL:
            raise RuntimeError(f"Baum-Welch {field}: kernel path {stats_err[field]:.3g} of max from plain")
    sums = estep_sum_times(fbw, gmm, topo, align_fn, graphs_w, S)
    # one more Baum-Welch iteration under the profiler: the card's busy share
    prof_wall, prof_dev, prof_top, prof_named = device_profile(lambda: pipe.train_gmm(
        train_fbs, topo.lexicon, topo, gcfg, TrainConfig(num_em_iters=1), gmm=trained,
        mode="baum-welch", align_fn=align_fn, n_pdfs=S), names=("gmm_tc_kernel",) + fb_names)
    k1_iter_ms, k1_iter_launches = prof_named["gmm_tc_kernel"]
    iters = [("baum-welch", h, s, st) for h, s, st in zip(bw.history, bw.seconds, bw.stage_seconds)]
    iters.append(("viterbi", vt.history[0], vt.seconds[0], vt.stage_seconds[0]))
    iter_text = "; ".join(
        f"iter {i} {m}: {h:.4f} per frame, {n_train_frames / s:.0f} frames/s ({s:.3f} s; stage ms "
        + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in st.items()) + ")"
        for i, (m, h, s, st) in enumerate(iters))
    phase(8, f"training path on {len(train_corpus)} utterances ({len(train_fbs)} batches of {TRAIN_BATCH}, "
          f"{n_train_frames} frames; synthesized in {synth_s:.1f} s; corpus not cut): {iter_text}; "
          f"launches {train_launches}; Viterbi EM \"align\" stage ({train_launches['viterbi']} K2 launches, which "
          f"also write the pdf labels) {1e3 * vt.stage_seconds[0]['align']:.1f} ms; held-out WER of the re-estimated "
          f"GMM {dec.wer:.4f} "
          f"(bundle {BUNDLE_WER}, limit {MAX_WER}); one Baum-Welch E-step on the widest batch, kernel vs "
          f"plain path: max |err| / max " + ", ".join(f"{k} {v:.3g}" for k, v in stats_err.items())
          + f" (limit {STATS_TOL}); the E-step's fixed-order sums on that batch ({sums['frames']} of {sums['N']} "
          f"frames labelled): over states {sums['index_sum_ms']:.3f} ms (atomic index_add_, replaced: "
          f"{sums['index_add_ms']:.3f} ms), posteriors J={sums['J']} to pdfs {sums['collapse_ms']:.3f} ms (atomic "
          f"scatter_add_, replaced: {sums['scatter_add_ms']:.3f} ms); a profiled Baum-Welch iteration: {prof_wall:.1f} ms wall, "
          f"{prof_dev:.1f} ms on the device ({100 * prof_dev / prof_wall:.1f}% busy), K1 {k1_iter_ms:.1f} ms "
          f"over {k1_iter_launches} launches, "
          + ", ".join(f"{n} {prof_named[n][0]:.2f} ms over {prof_named[n][1]} launches" for n in fb_names)
          + "; top device events "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof_top))

    k4_entry = hybrid_phases(dev)
    arm_entries = scorer_arm_phases(dev, gmm, fcfg, dcfg, graph, corpus, bcfg, k1_hyps, sfu_exps_per_s)
    entry = training_entry_phases(dev, corpus, bcfg, meta)
    lm_entry = lm_lattice_phases(dev, gmm, fcfg, dcfg, tied, graph, corpus, bcfg,
                                 [words for _id, _wave, words in train_corpus], run.wer, k3_decode_dev)
    phase(21, decode_cli_phase(dev))
    cli_line, cli_launches = gmm_cli_phase(dev, corpus, topo.lexicon, entry["mono_ckpt"], plain_wer)
    phase(22, cli_line)
    stream = streaming_phases(dev, gmm, fcfg, dcfg, graph, corpus, bcfg)
    adapt_paths = adaptation_phases(dev, gmm, fcfg, dcfg, graph, tied, topo, held_out, bcfg, train_corpus, train_fbs,
                                    train_speakers, trained, gcfg, entry, plain_wer)
    adapt_cli = adaptation_cli_phase(dev, corpus, topo.lexicon)
    neural = neural_phases(dev, gmm, topo, tied, fcfg, dcfg, graph, corpus, bcfg, train_fbs)
    nn_cli = nn_cli_phase(dev)
    ce_model = neural.pop("model")
    ctc_res = ctc_phases(dev, topo, fcfg, corpus, bcfg, train_fbs, ce_model)
    ctc_cli = ctc_cli_phase(dev)
    serving = serving_phases(dev, gmm, fcfg, dcfg, graph, held_out, ctc_res.pop("model"), sfu_exps_per_s)
    serve_cli = serve_cli_phase(dev)
    rnnt_res = rnnt_phases(dev, topo, fcfg, corpus, bcfg, train_fbs, ce_model)
    rnnt_cli = rnnt_cli_phase(dev)
    aed_res = aed_phases(dev, topo, fcfg, corpus, bcfg, train_fbs)
    aed_cli = aed_cli_phase(dev)
    dist_res = dist_phases(dev, gmm, topo, tied, fcfg, dcfg, graph, corpus, bcfg, train_fbs)

    if "jax" in sys.modules or "mogasr" in sys.modules:
        raise RuntimeError("jax or mogasr was imported; the port and this script must run without them")
    paths = {"decode": decode_launches, "train": train_launches, "recipe": entry["recipe"],
             "recipe_bundle_decode": entry["recipe_decode"], "mmi": entry["mmi"], "smbr": entry["smbr"],
             "lm_decode": lm_entry["lm_decode"], "lm_check_decodes": lm_entry["lm_check_decodes"],
             "confidence": lm_entry["confidence"], "cli": cli_launches, "streaming": stream["streaming"],
             "online": stream["online"], "stream_cli": stream["stream_cli"], **adapt_paths,
             "adapt_cli": adapt_cli, **neural["paths"], "nn_cli": nn_cli, **ctc_res["paths"], "ctc_cli": ctc_cli,
             **serving["paths"], "serve_cli": serve_cli, **rnnt_res["paths"], "rnnt_cli": rnnt_cli,
             **aed_res["paths"], "aed_cli": aed_cli, **dist_res}
    by_path = {k: {p: c.get(k, 0) for p, c in paths.items()} for k in train_launches}
    for e in (k4_entry, *arm_entries):  # K4, K1w and K5 (none of their launches on the CLI path)
        e["launches_by_path"]["cli"] = cli_launches[e["name"]]
        e["launches"] += cli_launches[e["name"]]
    # K2's chunk arm and its backtrace alone, on the online path and in the stream twin
    k2_chunk = stream["k2_chunk"]
    k2_chunk["launches_by_path"]["stream_cli"] = {"chunk": stream["stream_cli"]["viterbi_chunk"],
                                                  "backtrace": stream["stream_cli"]["viterbi_backtrace"]}
    k2_chunk["launches"] += stream["stream_cli"]["viterbi_chunk"] + stream["stream_cli"]["viterbi_backtrace"]
    # K4's carry arm on the streaming LstmAm's path
    k4_entry["launches_by_path"]["stream_nn"] = stream["k4_carry"]["launches"]
    k4_entry["launches"] += stream["k4_carry"]["launches"]
    k4_entry["carry"] = stream["k4_carry"]
    # K4 on the neural-training slice's paths: the trained hybrid decode and the CLI twins (never in training)
    for name in ("nn_align", "nn_ce", "nn_seq", "nn_decode", "conformer", "nn_cli"):
        k4_entry["launches_by_path"][name] = paths[name]["lstm_scan"]
        k4_entry["launches"] += paths[name]["lstm_scan"]
    k4_entry["trained_decode"] = {**neural["hybrid"], "ce_training": neural["ce"]}
    # the CTC slice: K4 on the CTC encoder (decode, the distillation teacher, the CLI twins) and its carry
    # arm on stream --ctc's path; K2's chunk arm with skips; the sub-entries of phases 36-39
    ctc_names = ("ctc_train", "ctc_decode", "ctc_stream", "ctc_bpe", "ctc_distill", "ctc_init", "ctc_cli")
    for name in ctc_names:
        k4_entry["launches_by_path"][name] = paths[name]["lstm_scan"]
        k4_entry["launches"] += paths[name]["lstm_scan"]
    for name in ("ctc_stream", "ctc_cli"):
        k4_entry["carry"]["launches_by_path"][name] = paths[name]["lstm_scan_carry"]
        k4_entry["carry"]["launches"] += paths[name]["lstm_scan_carry"]
        k2_chunk["launches_by_path"][name] = {"chunk": paths[name]["viterbi_chunk"],
                                              "backtrace": paths[name]["viterbi_backtrace"]}
        k2_chunk["launches"] += paths[name]["viterbi_chunk"] + paths[name]["viterbi_backtrace"]
    k4_entry["ctc_encoder"] = {**ctc_res["k4"], "training": ctc_res["train"], "decode": ctc_res["decode"]}
    # the serving slice: K4's carry arm in the CTC engine and the serve twin; K2's ragged chunk arm and its
    # backtrace alone in the GMM engine and the serve twin
    for name in ("serve_ctc", "serve_ctc_exact", "serve_cli"):
        k4_entry["launches_by_path"][name] = paths[name]["lstm_scan"]
        k4_entry["launches"] += paths[name]["lstm_scan"]
        k4_entry["carry"]["launches_by_path"][name] = paths[name]["lstm_scan_carry"]
        k4_entry["carry"]["launches"] += paths[name]["lstm_scan_carry"]
    k4_entry["carry_tick"] = serving["k4_tick"]
    # the RNN-T and neural-LM slice: K4 on the RNN-T encoder (decodes, the stream's offline reference, the
    # engine's dedicated streams and the CLI twins) and the NNLM scorers, its carry arm in the stream, the
    # engine and the twins (never under autograd: RNN-T, pruned, MWER and NNLM training run the plain
    # recurrence)
    rnnt_k4 = ("rnnt_decode", "rnnt_mwer", "rnnt_stream", "serve_rnnt", "serve_rnnt_exact", "nnlm", "rnnt_cli")
    for name in rnnt_k4:
        k4_entry["launches_by_path"][name] = paths[name]["lstm_scan"]
        k4_entry["launches"] += paths[name]["lstm_scan"]
    for name in ("rnnt_stream", "serve_rnnt", "serve_rnnt_exact", "rnnt_cli"):
        k4_entry["carry"]["launches_by_path"][name] = paths[name]["lstm_scan_carry"]
        k4_entry["carry"]["launches"] += paths[name]["lstm_scan_carry"]
    k4_entry["rnnt_encoder"] = {**rnnt_res["k4_encoder"], "launches": paths["rnnt_decode"]["lstm_scan"],
                                "decode": rnnt_res["decode"], "training": rnnt_res["train"],
                                "pruned_and_mwer": rnnt_res["steps"], "loss": rnnt_res["loss"]}
    k4_entry["nnlm"] = {**rnnt_res["k4_nnlm"], "launches": paths["nnlm"]["lstm_scan"], "lms": rnnt_res["nnlm"]}
    k4_entry["rnnt_engine_tick"] = {**rnnt_res["k4_tick"], "launches": paths["serve_rnnt"]["lstm_scan_carry"],
                                    "engine": rnnt_res["engine"]}
    serve_k2 = ("serve_gmm", "serve_gmm_exact", "serve_gmm_host", "serve_cli")
    for name in serve_k2:
        k2_chunk["launches_by_path"][name] = {"chunk": paths[name]["viterbi_chunk"],
                                              "backtrace": paths[name]["viterbi_backtrace"]}
        k2_chunk["launches"] += paths[name]["viterbi_chunk"] + paths[name]["viterbi_backtrace"]
    ragged = serving["ragged"]
    k2_chunk["ctc_skip"] = ctc_res["stream"]
    k3c = ctc_res["k3"]
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    k3d = lm_entry["k3_decode_batch"]
    k1_main = ("bfloat16", "max")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "gmm_score", "route": "cuda", "source": "mogasr_torch/csrc/gmm_score.cu",
         "replaces": "mogasr/am/gmm_pallas.py:154", "launches": launches["gmm_score"],
         "launches_by_path": by_path["gmm_score"],
         "max_abs_err": k1_err[(main_name, *k1_main)],
         "ms": k1_ms[k1_main][0], "plain_ms": k1_ms[k1_main][1],
         "bound_ms": k1_bounds[k1_main][0], "bound_by": k1_bounds[k1_main][1], "library_ms": None,
         "float32_sum_decode_batch": {"ms": k1_ms[("float32", "sum")][0], "plain_ms": k1_ms[("float32", "sum")][1],
                                      "bound_ms": k1_bounds[("float32", "sum")][0],
                                      "bound_by": k1_bounds[("float32", "sum")][1]},
         "float32_sum_training_batch": {"n": Bw * Tw, "ms": k1_train_ms, "plain_ms": k1_train_plain_ms,
                                        "max_abs_err": k1_train_err, "bound_ms": k1_train_bound[0],
                                        "bound_by": k1_train_bound[1], "profiled_iteration_ms": k1_iter_ms,
                                        "profiled_iteration_launches": k1_iter_launches}},
        {"name": "viterbi", "route": "cuda", "source": "mogasr_torch/csrc/viterbi.cu",
         "replaces": "mogasr/decoder/viterbi_pallas.py:54", "launches": launches["viterbi"],
         "launches_by_path": by_path["viterbi"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_main_bound[0], "bound_by": k2_main_bound[1], "library_ms": None,
         "align": k2_align, "viterbi_em_align_stage_ms": 1e3 * vt.stage_seconds[0]["align"],
         "collect_cd_stats": entry["collect_cd_stats"], "chunk": k2_chunk,
         "conformer_hybrid": neural["conformer"], "ctc_word_loop": ctc_res["k2"]},
        {"name": "fb_forward", "route": "cuda", "source": "mogasr_torch/csrc/forward_backward.cu",
         "replaces": "mogasr/decoder/fb_pallas.py:46", "launches": launches["fb_forward"],
         "launches_by_path": by_path["fb_forward"], "arm": fb_train["arm"],
         "max_abs_err": fb_train["ll_err"], "ms": fb_train["fb_forward_kernel"], "plain_ms": fb_train["plain_fwd_ms"],
         "bound_ms": fb_train["bounds"]["fwd"][0], "bound_by": fb_train["bounds"]["fwd"][1], "library_ms": None,
         "iteration_device_ms": prof_named["fb_forward_kernel"][0],
         "iteration_launches": prof_named["fb_forward_kernel"][1],
         "word_loop": {"arm": fb_loop["arm"], "max_abs_err": fb_loop["ll_err"], "ms": fb_loop["fb_forward_kernel"],
                       "plain_ms": fb_loop["plain_fwd_ms"], "bound_ms": fb_loop["bounds"]["fwd"][0],
                       "bound_by": fb_loop["bounds"]["fwd"][1]},
         "mmi_denominator": entry["mmi_denominator"],
         "sequence_training": neural["seq"],
         "ctc_loss": {"arm": k3c["arm"], "shape": k3c["shape"], "max_abs_err": k3c["max_abs_err"],
                      "loss_rel_err": k3c["loss_rel_err"], "grad_max_abs_err": k3c["grad_max_abs_err"],
                      "ms": k3c["ms"]["fb_forward_kernel"], "plain_ms": k3c["plain_ms"],
                      "bound_ms": k3c["bounds"]["fwd"][0], "bound_by": k3c["bounds"]["fwd"][1],
                      "loss_and_backward_ms": k3c["loss_ms"], "plain_loss_and_backward_ms": k3c["loss_plain_ms"],
                      "library_loss_and_backward_ms": k3c["library_loss_ms"],
                      "device_prefix_beam": ctc_res["beam"]},
         "rnnt_aux_ctc": {"launches_per_step": rnnt_res["train"]["k3_launches_per_step"],
                          "training_ms_per_step": rnnt_res["train"]["ms_per_step"], **rnnt_res["aux_ctc"]},
         # the AED slice: the aux CTC term of its training step and the joint rescoring of its beam
         "aed_aux_ctc": {"launches_per_step": aed_res["train"]["k3_launches_per_step"],
                         "training": aed_res["train"], "objective": aed_res["objective"], **aed_res["aux_ctc"]},
         "aed_rescore": {**aed_res["rescore"], "held_out_decode": aed_res["decode"],
                         "families_decode": aed_res["families"], "stream": aed_res["stream"],
                         "engine": aed_res["engine"], "mwer": aed_res["mwer"]},
         "decode_batch": {"arm": k3d["arm"], "shape": [k3d["B"], k3d["T"], k3d["J"]], "ms": k3d["fb_forward_kernel"],
                          "plain_ms": k3d["plain_fwd_ms"], "max_abs_err": k3d["loglik_max_abs_err"],
                          "bound_ms": k3d["bounds"]["fwd"][0], "bound_by": k3d["bounds"]["fwd"][1],
                          "launches_per_batch": k3d["launches_per_batch"], "pair_ms": k3d["pair_ms"],
                          "pair_bound_ms": k3d["bounds"]["pair"][0]}},
        {"name": "fb_backward", "route": "cuda", "source": "mogasr_torch/csrc/forward_backward.cu",
         "replaces": "mogasr/decoder/fb_pallas.py:77", "launches": launches["fb_backward"],
         "launches_by_path": by_path["fb_backward"], "arm": fb_train["arm"],
         "max_abs_err": fb_train["post_err"], "ms": fb_train["fb_backward_kernel"],
         "plain_ms": fb_train["plain_bwd_ms"],
         "bound_ms": fb_train["bounds"]["bwd"][0], "bound_by": fb_train["bounds"]["bwd"][1], "library_ms": None,
         "iteration_device_ms": prof_named["fb_backward_kernel"][0],
         "iteration_launches": prof_named["fb_backward_kernel"][1],
         "word_loop": {"arm": fb_loop["arm"], "max_abs_err": fb_loop["post_err"], "ms": fb_loop["fb_backward_kernel"],
                       "plain_ms": fb_loop["plain_bwd_ms"], "bound_ms": fb_loop["bounds"]["bwd"][0],
                       "bound_by": fb_loop["bounds"]["bwd"][1]},
         "ctc_loss": {"arm": k3c["arm"], "shape": k3c["shape"], "grad_max_abs_err": k3c["grad_max_abs_err"],
                      "ms": k3c["ms"]["fb_backward_kernel"], "bound_ms": k3c["bounds"]["bwd"][0],
                      "bound_by": k3c["bounds"]["bwd"][1], "combine_ms": k3c["ms"]["fb_combine_kernel"],
                      "combine_bound_ms": k3c["bounds"]["combine"][0]},
         "decode_batch": {"arm": k3d["arm"], "shape": [k3d["B"], k3d["T"], k3d["J"]], "ms": k3d["fb_backward_kernel"],
                          "plain_ms": k3d["plain_bwd_ms"], "bound_ms": k3d["bounds"]["bwd"][0],
                          "bound_by": k3d["bounds"]["bwd"][1], "launches_per_batch": k3d["launches_per_batch"]},
         # the combine launch (alpha + beta - loglik) and the three launches together
         "combine": {"launches": launches["fb_combine"], "ms": fb_train["fb_combine_kernel"],
                     "bound_ms": fb_train["bounds"]["combine"][0], "bound_by": fb_train["bounds"]["combine"][1],
                     "iteration_device_ms": prof_named["fb_combine_kernel"][0],
                     "word_loop_ms": fb_loop["fb_combine_kernel"], "decode_batch_ms": k3d["fb_combine_kernel"],
                     "decode_batch_bound_ms": k3d["bounds"]["combine"][0]},
         "pair": {"ms": fb_train["pair_ms"], "one_call_ms": fb_train["pair_one_call_ms"],
                  "bound_ms": fb_train["bounds"]["pair"][0],
                  "bound_by": fb_train["bounds"]["pair"][1], "word_loop_ms": fb_loop["pair_ms"],
                  "word_loop_bound_ms": fb_loop["bounds"]["pair"][0]}},
        k4_entry,
        *arm_entries,
        {"name": "viterbi_chunk_ragged", "route": "cuda", "source": "mogasr_torch/csrc/viterbi.cu",
         "replaces": "mogasr/decoder/viterbi_pallas.py:54", "launches": paths["serve_gmm"]["viterbi_chunk"],
         "launches_by_path": {name: paths[name]["viterbi_chunk"] for name in serve_k2},
         "max_abs_err": ragged["max_abs_err"], "ms": ragged["ms"], "plain_ms": ragged["plain_ms"],
         "bound_ms": ragged["bound_ms"], "bound_by": ragged["bound_by"], "library_ms": None,
         "shape": ragged["shape"], "valid_frames": ragged["valid_frames"], "gmm_engine": serving["gmm"],
         "ctc_engine": serving["ctc"], "k1_float32_sum_tick": serving["k1_tick"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

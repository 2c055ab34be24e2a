#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mogasr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
takes no arguments and imports nothing of the JAX package ``mogasr`` or of
jax. Each phase prints one line; any failure raises, so the exit code is
nonzero and no result line is printed. Without a CUDA device it fails at once.

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
   there with CTC skip transitions inside every chain (K2's skip arm);
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
   limit); then 3 CD EM iterations run twice, and stopped after the first
   and resumed from their EM checkpoint: both bitwise equal to the first run
   in history and parameters;
17. MMI and sMBR from phase 16's monophone model: on the training batch
   with the most frames each side's statistics through K1 + K3 (numerator
   on K3's chain arm, the word-loop denominator on its general arm, arms
   checked) against a float64 run, and the EBW update from both; the
   denominator's K3 timed; 2 MMI iterations and 1 sMBR iteration over the
   corpus (launches, criterion, seconds per stage), the held-out WER of the
   three models;
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
   shape, 256 x 600 x 3048, beside its bound and the plain passes;
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
   after (K1 and K2 only).

The last three lines are the ``nvidia-smi`` line, a JSON object of the
kernels (launch counts of the decode and training paths; error against the
plain version, kernel and plain milliseconds, and the least time the card
could take, on the paths' own batches), and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
# uninterrupted run.
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


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


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


def kernel_device_ms(fn, names, reps: int):
    """Mean device milliseconds per call of ``fn`` spent in each named
    kernel, from ``torch.profiler`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # a profiling window late in a long run has come back without the
    # kernels' device activity (phase 20 on an H100): one more, then fail
    for _attempt in range(2):
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
    words); its lexicon must be the bundle's."""
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
    return [(u.utt_id, u.wave, u.words) for u in utts]


def training_batches(topo, fcfg, dev):
    """The training corpus of benchmarks/train_headline.py featurized on the
    card in its batches, the widest of them (the widest bucket used, 550
    frames, the one with the most frames) and the seconds its synthesis took."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.config import BatchConfig
    from mogasr_torch.data.batching import make_batches

    t0 = time.perf_counter()
    corpus = training_corpus(topo)
    synth_s = time.perf_counter() - t0
    batches = list(make_batches(corpus, BatchConfig(batch_size=TRAIN_BATCH, bucket_boundaries=TRAIN_BUCKETS), fcfg))
    frontends = pipe.frontends_for(batches, fcfg, dev)
    fbs = [pipe.featurize_batch(b, frontends[b.waves.shape[1]], dev) for b in batches]
    widest = max(fbs, key=lambda f: (f.feats.shape[1], int(f.n_frames.sum())))
    return corpus, fbs, widest, synth_s


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
    # stop-and-resume of 3 CD EM iterations from the recipe's CD model
    gcfg_cd = GmmConfig(n_states=tied.n_pdfs, n_components=args.components, feat_dim=out["fcfg"].feat_dim,
                        var_floor=args.var_floor, min_split_occ=args.min_split_occ)

    def cd_em(iters, ckpt_dir=None):
        return pipe.train_gmm(out["train"], b_topo.lexicon, out["topo"], gcfg_cd, TrainConfig(num_em_iters=iters),
                              gmm=gmm_cd, align_fn=lambda p: tri.align_graph_cd(tied, p), n_pdfs=tied.n_pdfs,
                              ckpt_dir=ckpt_dir)

    whole = cd_em(3)
    again = cd_em(3)
    cd_em(1, os.path.join(work, "em_ckpt"))
    resumed = cd_em(3, os.path.join(work, "em_ckpt"))
    if len(resumed.seconds) != 2 or "restore" not in resumed.setup_seconds:
        raise RuntimeError("the CD EM run did not resume from its checkpoint")
    for name, run in (("a second uninterrupted run", again), ("the run resumed after 1 of 3 iterations", resumed)):
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
          f"{dec.wer:.4f} ({dec.n_utts / dec.seconds:.1f} utt/s; bundle {BUNDLE_WER}); 3 CD EM iterations (history "
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
    smbr_res = smbr.train_smbr(tb, lex, topo_t, gmm_mono, n_iters=1, acoustic_scale=MMI_SCALE)
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
          f"{[arm_names[a] for a in last_arms]}); 1 sMBR iteration (corpus not cut): expected frame accuracy "
          f"{smbr_res.history}, {iter_text(smbr_res)}, launches {smbr_launches}; held-out WER "
          + ", ".join(f"{k} {v:.4f}" for k, v in evals.items()))

    # ---- phase 18: the CLI twin, killed and resumed
    phase(18, cli_twin_phase(dev))
    shutil.rmtree(work, ignore_errors=True)
    # the monophone model in the port's checkpoint format, for phase 22
    mono_ckpt = os.path.join(ROOT, "build", "chip_smoke_mono_ckpt")
    shutil.rmtree(mono_ckpt, ignore_errors=True)
    ckpt.save_checkpoint(mono_ckpt, gmm_mono._asdict())
    return {"mono_ckpt": mono_ckpt, "recipe": recipe_launches, "recipe_decode": dec_launches, "mmi": mmi_launches,
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


def lm_lattice_phases(dev, gmm, fcfg, dcfg, tied, graph, corpus, bcfg, train_texts, loop_wer) -> dict:
    """Phases 19 (LM decoding at full width) and 20 (lattices, confidence and
    n-best). Returns the launches of their paths and K3's numbers at the
    decode batch's shape for the kernels line."""
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
    # timed before the recursion's long profile below, printed in phase 20
    graphs_w = graphs[1]

    def k3():
        return fb_cuda.forward_backward(ll_w, graphs_w, fb_w.n_frames, acoustic_scale=dcfg.acoustic_scale)

    k3_call = per_call_ms(k3, 10)
    k3_dev = kernel_device_ms(k3, ("fb_forward_kernel", "fb_backward_kernel", "fb_combine_kernel"), 3)
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
    k3_entry = {"B": B, "T": T, "J": graph.n_states, "arm": "general", "pair_ms": k3_call, **k3_dev,
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
          f"{k3_bounds['pair'][0]:.4f} ms by {k3_bounds['pair'][1]}), K3f {k3_dev['fb_forward_kernel']:.3f} ms (bound "
          f"{k3_bounds['fwd'][0]:.4f}), K3b {k3_dev['fb_backward_kernel']:.3f} ms (bound {k3_bounds['bwd'][0]:.4f}), "
          f"combine {k3_dev['fb_combine_kernel']:.3f} ms (bound {k3_bounds['combine'][0]:.4f}); plain forward "
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
    from mogasr_torch.recipes.decode_held_out import held_out_corpus
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
    corpus = held_out_corpus(topo, meta, 768)
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
    train_corpus, train_fbs, fbw, synth_s = training_batches(topo, fcfg, dev)
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
    fb_names = ("fb_forward_kernel", "fb_backward_kernel", "fb_combine_kernel")
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
                                 [words for _id, _wave, words in train_corpus], run.wer)
    phase(21, decode_cli_phase(dev))
    cli_line, cli_launches = gmm_cli_phase(dev, corpus, topo.lexicon, entry["mono_ckpt"], plain_wer)
    phase(22, cli_line)

    if "jax" in sys.modules or "mogasr" in sys.modules:
        raise RuntimeError("jax or mogasr was imported; the port and this script must run without them")
    paths = {"decode": decode_launches, "train": train_launches, "recipe": entry["recipe"],
             "recipe_bundle_decode": entry["recipe_decode"], "mmi": entry["mmi"], "smbr": entry["smbr"],
             "lm_decode": lm_entry["lm_decode"], "lm_check_decodes": lm_entry["lm_check_decodes"],
             "confidence": lm_entry["confidence"], "cli": cli_launches}
    by_path = {k: {p: c.get(k, 0) for p, c in paths.items()} for k in train_launches}
    for e in (k4_entry, *arm_entries):  # K4, K1w and K5 (none of their launches on the CLI path)
        e["launches_by_path"]["cli"] = cli_launches[e["name"]]
        e["launches"] += cli_launches[e["name"]]
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
         "collect_cd_stats": entry["collect_cd_stats"]},
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
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

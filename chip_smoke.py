#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``mogasr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
takes no arguments and imports nothing of jax. Each phase prints one line;
any failure raises, so the exit code is nonzero and no result line is
printed. Without a CUDA device it fails at once.

0. device: the card's name and ``nvidia-smi`` name + power limit;
1. build: compile every kernel in mogasr_torch/csrc with nvcc;
2. K1 (csrc/gmm_score.cu) against the plain PyTorch scorer on the headline
   GMM, float32 and bfloat16, sum and max: on random features and on one
   batch of the main path (the 600-frame bucket, 256 x 600 frames), where
   it is also timed against the plain version;
3. K2 (csrc/viterbi.cu) against the plain PyTorch Viterbi on the headline
   word-loop graph, path, entered and score bitwise equal: on the main
   path's batch (B=256, T=600, ragged frame counts, its K1 emissions), where
   it is also timed, and on random emissions at another acoustic scale;
4. the front end on the card against the NumPy oracle;
5. the main path on the headline bundle and the 768 held-out utterances of
   bench.py (front end -> K1 bf16 max -> K2 -> path_to_tokens -> WER):
   WER, utt/s, RTF, per-stage ms, launch counts of a timed pass;
6. the same corpus through the plain float32 path on the card: transcript
   agreement with the kernel path.

Of the reference package ``mogasr`` it uses only the modules that import
numpy alone (config, hmm, data, eval, frontend.numpy_ref), as mogasr_torch
does; the run fails if jax was loaded all the same.

The last three lines are the ``nvidia-smi`` line, a JSON object of the
kernels (launch counts of the main path's timed pass; error against the
plain version and kernel and plain milliseconds, on the main path's batch),
and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(ROOT, "benchmarks", "headline")

# Kernel vs plain scorer, float32 and bfloat16 alike: both multiply the same
# operands (bf16-rounded ones in bfloat16 mode, where every product is exact
# in float32) and accumulate in float32, so they differ only in summation
# order. On the headline GMM either order sits within 2.5e-4 of a float64
# sum over |loglik| in [40, 640]; this is the reference's own golden
# tolerance (tests/test_golden.py), with a 4x margin at the smallest |loglik|.
K1_ATOL, K1_RTOL = 1e-3, 1e-4
FRONTEND_ATOL = 3e-4      # tests/test_golden.py
MAX_WER = 0.010           # the JAX system's WER on this corpus is 0.0069
MIN_AGREEMENT = 0.99      # transcripts identical to the plain float32 path
K1_TIMED = (("bfloat16", "max"), ("float32", "sum"))  # the main path's mode, the parity mode


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


def held_out_corpus(topo, meta, n_utts):
    """The held-out v2 utterances of bench.py (seed 999, 3-9 words)."""
    from mogasr.data import synthetic as syn

    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    utts = syn.make_corpus_v2(
        n_utts, lexicon=word_lex, speakers=syn.make_speakers(meta.get("speakers", 20)),
        style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9),
    )
    return [(u.utt_id, u.wave, u.words) for u in utts]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card")

    from mogasr.config import BatchConfig, DecodeConfig
    from mogasr.data.batching import make_batches
    from mogasr.frontend.numpy_ref import extract_features_np
    from mogasr.hmm import triphone as tri
    from mogasr_torch import _cuda
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import gmm_cuda
    from mogasr_torch.am.gmm import gmm_loglik
    from mogasr_torch.decoder import viterbi as vit
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.frontend.torch_frontend import make_frontend
    from mogasr_torch.utils.bundle import load_system

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(0, f"device {kind!r}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

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
    # the main path's widest batch: 256 rows x 600 frames, ragged n_frames
    batch = max(make_batches(corpus, bcfg, fcfg), key=lambda b: b.waves.shape[1])
    fb = pipe.featurize_batch(batch, make_frontend(fcfg, batch.waves.shape[1], dev), dev)
    B, T, _ = fb.feats.shape

    # ---- phase 2: K1 against its plain version
    def k1(x, dt, mode):
        return gmm_cuda.gmm_loglik_fused(x, gmm, dt, mode, params=params[dt])

    def k1_plain(x, dt, mode):
        return gmm_loglik(x, gmm, mode=mode, compute_dtype=dt)

    params = {dt: gmm_cuda.kernel_params(gmm, dt) for dt in ("float32", "bfloat16")}
    x_main = fb.feats.reshape(B * T, D)
    main_name = f"main-path batch N={B * T}"
    inputs = {
        "random N=8192": torch.as_tensor(rng.standard_normal((8192, D)).astype(np.float32), device=dev),
        main_name: x_main,
    }
    k1_ms, k1_err = {}, {}
    for name, x in inputs.items():
        for dt in ("float32", "bfloat16"):
            for mode in ("sum", "max"):
                if x is x_main and (dt, mode) in K1_TIMED:
                    ms, got = timed(lambda: k1(x, dt, mode), 5)
                    plain_ms, want = timed(lambda: k1_plain(x, dt, mode), 3)
                    k1_ms[(dt, mode)] = (ms, plain_ms)
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
    phase(2, "K1 matches plain (atol %g rtol %g), max |err|: %s; at N=%d bf16/max %.3f ms "
          "(plain %.3f ms), f32/sum %.3f ms (plain %.3f ms)" % (
              K1_ATOL, K1_RTOL, ", ".join(f"{n} {d}/{m} {e:.3g}" for (n, d, m), e in k1_err.items()),
              B * T, *k1_ms[("bfloat16", "max")], *k1_ms[("float32", "sum")]))

    # ---- phase 3: K2 against its plain version, bitwise
    ll_main = k1(x_main, "bfloat16", "max").reshape(B, T, S)
    _, graphs_main = pipe.decode_graphs(graph, B, dev)
    _, graphs16 = pipe.decode_graphs(graph, 16, dev)
    cases = {
        f"main-path batch B={B} T={T}, scale {dcfg.acoustic_scale:g}": (
            ll_main, graphs_main, fb.n_frames, dcfg.acoustic_scale),
        "random emissions B=16, scale 0.7": (
            torch.as_tensor((rng.standard_normal((16, T, S)) * 4 - 20).astype(np.float32), device=dev),
            graphs16,
            torch.as_tensor(np.r_[T, rng.integers(1, T, 14), 0].astype(np.int32), device=dev),
            0.7,
        ),
    }
    k2_err = 0.0
    for name, (ll, graphs, nf, scale) in cases.items():
        if ll is ll_main:
            k2_ms, got = timed(lambda: viterbi_cuda.viterbi(ll, graphs, nf, acoustic_scale=scale), 5)
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
    phase(3, f"K2 bitwise equal to plain on J={J}: {'; '.join(cases)}; main-path batch "
          f"({int((fb.n_frames > 0).sum())} rows with frames, {int(fb.n_frames.sum())} frames) "
          f"{k2_ms:.3f} ms (plain {k2_plain_ms:.3f} ms)")
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

    # ---- phase 5: the main path, one warm pass, then a timed pass
    def main_path():
        return pipe.decode_corpus(corpus, gmm, graph, fcfg, dcfg, bcfg, dev,
                                  compute_dtype="bfloat16")

    main_path()
    gmm_cuda.LAUNCHES = 0
    viterbi_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    run = main_path()
    launches = {"gmm_score": gmm_cuda.LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES}
    if min(launches.values()) == 0:
        raise RuntimeError(f"the main path did not go through every kernel: {launches}")
    if run.n_utts != len(corpus) or not np.isfinite(run.scores).all():
        raise RuntimeError(f"main path decoded {run.n_utts} of {len(corpus)} utterances, "
                           f"finite scores: {bool(np.isfinite(run.scores).all())}")
    if run.wer > MAX_WER:
        raise RuntimeError(f"main path WER {run.wer:.4f} > {MAX_WER}")
    stages = ", ".join(f"{k} {1e3 * v:.1f}" for k, v in run.stage_seconds.items())
    phase(5, f"main path: {run.n_utts} utts, WER {run.wer:.4f}, {run.n_utts / run.seconds:.1f} utt/s, "
          f"RTF {run.seconds / run.audio_seconds:.6f} ({run.seconds:.3f} s for "
          f"{run.audio_seconds:.1f} s of audio); stage ms: {stages}; launches {launches}")

    # ---- phase 6: the plain float32 path on the card
    plain = pipe.decode_corpus(corpus, gmm, graph, fcfg, dcfg, bcfg, dev,
                               compute_dtype="float32", use_kernels=False)
    same = sum(a == b for a, b in zip(run.hyps, plain.hyps)) / len(run.hyps)
    if same < MIN_AGREEMENT:
        raise RuntimeError(f"kernel path agrees with the plain f32 path on {same:.4f} of utterances")
    phase(6, f"plain f32 path: WER {plain.wer:.4f}; transcripts identical to the kernel path "
          f"on {same:.4f} of {len(run.hyps)} utterances")

    if "jax" in sys.modules:
        raise RuntimeError("jax was imported; the port and this script must run without it")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "gmm_score", "route": "cuda", "source": "mogasr_torch/csrc/gmm_score.cu",
         "replaces": "mogasr/am/gmm_pallas.py:154", "launches": launches["gmm_score"],
         "max_abs_err": k1_err[(main_name, "bfloat16", "max")],
         "ms": k1_ms[("bfloat16", "max")][0], "plain_ms": k1_ms[("bfloat16", "max")][1]},
        {"name": "viterbi", "route": "cuda", "source": "mogasr_torch/csrc/viterbi.cu",
         "replaces": "mogasr/decoder/viterbi_pallas.py:54", "launches": launches["viterbi"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

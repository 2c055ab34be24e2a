"""Driver entry points: the single-card forward step and the multi-rank dry
run, the twins of the reference's ``__graft_entry__.py``.

- :func:`entry` returns the fused ASR forward step of the flagship model (the
  front end, GMM scoring at 1000 states x 256 components x 39 dims with
  kernel K1 float32/sum, Viterbi over the word loop with kernel K2) and its
  example arguments, on the card unless the caller asks for the CPU.
- :func:`dryrun_multichip` runs every section of the reference's dry run
  over ``n`` ranks (``dist.launch.run_ranks``): the data-parallel align, EM,
  CE, MMI, CTC, MPC, distillation, RNN-T (dense and pruned), AED, MWER,
  soft-EM and decode steps; the 2-D tensor-parallel GMM score and MLP step;
  the GPipe step; the expert-parallel MoeAm step; the sequence-parallel
  front-end tail. It prints the reference's summary line. Where the
  reference checks that its Pallas LSTM stays off on a multi-device mesh,
  this checks that the data-parallel training steps ran the plain
  recurrence: kernel K4 has no backward, and its wrapper refuses a forward
  under autograd (``_cuda.refuse_grad``).

    python -m mogasr_torch.graft_entry [--n 2] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from mogasr_torch.config import DecodeConfig, TrainConfig


def _build_setup(n_utts: int = 4, seed: int = 0):
    """(fcfg, lexicon, topology, the first batch) of the reference's setup:
    ``n_utts`` synthetic utterances of 1-2 words in the 150-frame bucket."""
    from mogasr_torch.config import BatchConfig, FrontendConfig, TopologyConfig
    from mogasr_torch.data.batching import make_batches
    from mogasr_torch.data.synthetic import make_corpus
    from mogasr_torch.hmm.lexicon import synthetic_lexicon
    from mogasr_torch.hmm.topology import build_topology

    fcfg = FrontendConfig()
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    utts = make_corpus(n_utts, words_per_utt=(1, 2), seed=seed)
    bcfg = BatchConfig(batch_size=n_utts, bucket_boundaries=(150,))
    batch = next(iter(make_batches([(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg)))
    return fcfg, lex, topo, batch


def headline_gmm(S: int = 1000, K: int = 256, D: int = 39, seed: int = 0):
    """The reference's headline-scale random GMM (numpy, from ``seed``):
    weights, means, variances."""
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.standard_normal((S, K, D)).astype(np.float32),
            (0.5 + rng.random((S, K, D))).astype(np.float32))


def entry(device: Optional[str] = None):
    """(fn, example_args): ``fn(waves [B, N], num_samples [B]) -> (path
    [B, T], score [B])``, the fused forward step; on the card unless
    ``device`` says otherwise."""
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am.gmm import gmm_from_numpy
    from mogasr_torch.am.gmm_cuda import gmm_loglik_batched, kernel_params
    from mogasr_torch.decoder import viterbi_cuda
    from mogasr_torch.decoder.viterbi import graphs_to_torch
    from mogasr_torch.frontend.torch_frontend import make_frontend
    from mogasr_torch.hmm import graph as gr

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device (pass device='cpu' to run the plain versions)")
    fcfg, lex, topo, batch = _build_setup()
    dcfg = DecodeConfig()
    gmm = gmm_from_numpy(*headline_gmm(D=fcfg.feat_dim), device=dev)
    params = kernel_params(gmm, "float32") if dev.type == "cuda" else None
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    graphs = graphs_to_torch(gr.batch_graphs([graph] * batch.waves.shape[0]), dev)
    frontend = make_frontend(fcfg, batch.waves.shape[1], dev)

    @torch.no_grad()
    def forward(waves: torch.Tensor, num_samples: torch.Tensor):
        feats, n_frames = frontend(waves, num_samples)
        ll = gmm_loglik_batched(feats, gmm, compute_dtype="float32", mode="sum", params=params)
        res = viterbi_cuda.viterbi(ll, graphs, n_frames, acoustic_scale=dcfg.acoustic_scale)
        return res.path, res.score

    example_args = (torch.as_tensor(batch.waves, device=dev), torch.as_tensor(batch.num_samples, device=dev))
    return forward, example_args


# --------------------------------------------------------------------------
# The dry run
# --------------------------------------------------------------------------


def _linear_scorer(params, feats):
    return feats @ params["W"] + params["b"]


def _dryrun_rank(rank: int, mesh, n: int) -> dict:
    """Every section of the reference's dry run on this rank; returns the
    summary's values (replicated: equal on every rank) and this rank's
    kernel launches."""
    from mogasr_torch import _cuda
    from mogasr_torch import pipeline as pipe
    from mogasr_torch.am import em
    from mogasr_torch.am.aed import build_aed_model
    from mogasr_torch.am.gmm import gmm_from_numpy
    from mogasr_torch.am.neural import build_model
    from mogasr_torch.am.params import init_
    from mogasr_torch.am.rnnt import build_rnnt_model
    from mogasr_torch.am.train_nn import init_train_state
    from mogasr_torch.config import TopologyConfig
    from mogasr_torch.dist import expert_parallel as EP
    from mogasr_torch.dist import mesh as M
    from mogasr_torch.dist import pipeline_parallel as PP
    from mogasr_torch.dist import sequence_parallel as SP
    from mogasr_torch.dist import sharded as SH
    from mogasr_torch.dist import tensor_parallel as TP
    from mogasr_torch.hmm import graph as gr
    from mogasr_torch.hmm.lexicon import make_lexicon
    from mogasr_torch.hmm.topology import build_topology

    dev = mesh.device
    start = _cuda.launch_counts()
    rng = np.random.default_rng(0)
    S, K, D = 8, 2, 5
    gmm_np = (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
              rng.standard_normal((S, K, D)).astype(np.float32),
              (0.5 + rng.random((S, K, D))).astype(np.float32))
    gmm = M.replicate(gmm_from_numpy(*gmm_np, device=dev), mesh)
    out = {}

    # --- align (one utterance a rank) ---
    lex = make_lexicon({"ab": ["a", "b"]})
    topo = build_topology(lex, TopologyConfig(states_per_phone=1, sil_states=1))
    B, T = n, 12
    graphs_np = gr.batch_graphs([gr.align_graph(topo, lex.words_to_phone_ids(["ab"]))] * B)
    feats_b = rng.standard_normal((B, T, D)).astype(np.float32)
    nf = np.full(B, T, np.int32)
    res = SH.make_sharded_align_step(mesh)(gmm, *M.shard_batch((feats_b, nf, graphs_np), mesh))
    out["align_score"] = float(SH.sum_tensors([res.score.sum().reshape(1)], mesh)[0])

    # --- EM: statistics summed over the ranks, then the M-step ---
    N = 8 * n
    feats = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, S, N).astype(np.int64)
    stats = SH.make_sharded_em_step(mesh)(gmm, *M.shard_batch((feats, labels), mesh))
    if em.m_step(gmm, stats).means.shape != (S, K, D):
        raise RuntimeError("EM: the M-step changed the GMM's shape")
    out["em_loglik"] = float(stats.loglik)

    def trained(model, state_seed: int):
        model = M.replicate(init_(model, torch.Generator().manual_seed(state_seed)), mesh)
        return model, init_train_state(model, cfg)

    # --- CE (and the K4 check: DP training runs the plain recurrence) ---
    cfg = TrainConfig(nn_hidden=16, nn_layers=1, nn_context=1, num_nn_steps=4)
    fb = rng.standard_normal((n * 2, 6, D)).astype(np.float32)
    lb = rng.integers(0, S, (n * 2, 6)).astype(np.int64)
    nfb = np.full(n * 2, 6, np.int32)
    model, state = trained(build_model("mlp", S, cfg, D), 0)
    _, m = SH.make_sharded_train_step(model, cfg, mesh)(state, *M.shard_batch((fb, nfb, lb), mesh))
    out["nn_loss"] = m["loss"]
    lstm, lstm_state = trained(build_model("lstm", S, TrainConfig(nn_hidden=8, nn_layers=2, num_nn_steps=4), D), 1)
    k4 = _cuda.launch_counts()["lstm_scan"]
    SH.make_sharded_train_step(lstm, cfg, mesh)(lstm_state, *M.shard_batch((fb, nfb, lb), mesh))
    if _cuda.launch_counts()["lstm_scan"] != k4:
        raise RuntimeError("the data-parallel CE step launched K4 (it has no backward)")

    # --- MMI ---
    num_np = gr.batch_graphs([gr.align_graph(topo, lex.words_to_phone_ids(["ab"]))] * n)
    den_np = gr.batch_graphs([pipe.word_decode_graph(lex, topo, DecodeConfig())] * n)
    mmi_feats = rng.standard_normal((n, 12, D)).astype(np.float32)
    mmi_model, mmi_state = trained(build_model("mlp", S, cfg, D), 5)
    _, m = SH.make_sharded_nn_mmi_step(mmi_model, cfg, mesh, torch.zeros(S))(
        mmi_state, *M.shard_batch((mmi_feats, np.full(n, 12, np.int32), num_np, den_np), mesh))
    out["mmi_per_frame"] = m["mmi_per_frame"]

    # --- CTC, MPC, distillation ---
    ctc_model, ctc_state = trained(build_model("mlp", 5, cfg, D), 1)
    ctc_labels = rng.integers(0, 4, (n * 2, 2)).astype(np.int32)
    ctc_nl = np.full(n * 2, 2, np.int32)
    ctc_in = M.shard_batch((fb, nfb, ctc_labels, ctc_nl), mesh)
    _, m = SH.make_sharded_ctc_train_step(ctc_model, cfg, mesh)(ctc_state, *ctc_in)
    out["ctc_loss"] = m["loss"]
    mpc_model, mpc_state = trained(build_model("mlp", D, cfg, D), 6)
    _, m = SH.make_sharded_mpc_step(mpc_model, cfg, mesh)(mpc_state, *M.shard_batch((fb, nfb), mesh))
    out["mpc_loss"] = m["loss"]
    stud, stud_state = trained(build_model("mlp", 5, cfg, D), 5)
    _, m = SH.make_sharded_distill_train_step(stud, ctc_model, cfg, mesh)(stud_state, *ctc_in)
    out["distill_loss"] = m["loss"]

    # --- RNN-T, dense and pruned ---
    rnnt, rnnt_state = trained(build_rnnt_model(5, cfg, D), 2)
    _, m = SH.make_sharded_rnnt_train_step(rnnt, cfg, mesh)(rnnt_state, *ctc_in)
    out["rnnt_loss"] = m["loss"]
    rnnt_p, rnnt_p_state = trained(build_rnnt_model(5, cfg, D, simple_heads=True), 7)
    SH.make_sharded_rnnt_pruned_train_step(rnnt_p, cfg, mesh, band=2)(rnnt_p_state, *ctc_in)

    # --- AED and MWER (x4 subsampling: 16 frames -> 4 encoder frames) ---
    aed, aed_state = trained(build_aed_model(5, cfg, D), 3)
    fb_aed = rng.standard_normal((n * 2, 16, D)).astype(np.float32)
    nfb_aed = np.full(n * 2, 16, np.int32)
    _, m = SH.make_sharded_aed_train_step(aed, cfg, mesh)(
        aed_state, *M.shard_batch((fb_aed, nfb_aed, ctc_labels, ctc_nl), mesh))
    out["aed_loss"] = m["loss"]
    Bm, Nh, Uh = n * 2, 2, ctc_labels.shape[1]
    hyps = np.full((Bm, Nh, Uh), -1, np.int32)
    n_h = np.zeros((Bm, Nh), np.int32)
    for b in range(Bm):
        for j in range(Nh):
            k = 1 + (b + j) % Uh
            hyps[b, j, :k] = rng.integers(0, 5, k)
            n_h[b, j] = k
    risks = rng.random((Bm, Nh)).astype(np.float32)
    _, m = SH.make_sharded_aed_mwer_step(aed, cfg, mesh)(aed_state, *M.shard_batch(
        (fb_aed, nfb_aed, hyps, n_h, np.ones((Bm, Nh), bool), risks, ctc_labels, ctc_nl), mesh))
    out["mwer_risk"] = m["expected_risk"]

    # --- soft EM and decode ---
    feats_soft = rng.standard_normal((B, T, D)).astype(np.float32)
    soft_in = M.shard_batch((feats_soft, nf, graphs_np), mesh)
    soft = SH.make_sharded_soft_em_step(mesh)(gmm, *soft_in)
    if em.m_step(gmm, soft).means.shape != (S, K, D):
        raise RuntimeError("soft EM: the M-step changed the GMM's shape")
    out["soft_loglik"] = float(soft.loglik)
    _, totals = SH.make_sharded_decode_step(mesh)(gmm, *soft_in)
    if totals["frames"] != int(nf.sum()):
        raise RuntimeError(f"decode: {totals['frames']} frames summed, {int(nf.sum())} given")
    out["decode_frames"] = totals["frames"]

    # --- tensor parallel: 2-D (data, model) ---
    n_model = 2 if n % 2 == 0 else 1
    mesh2d = TP.make_tp_mesh(n // n_model, n_model, dev)
    Btp = max(2, mesh2d.shape["data"])
    feats_tp = rng.standard_normal((Btp, T, D)).astype(np.float32)
    rows = M.data_rows(Btp, mesh2d.data)
    ll_tp = TP.make_tp_score_step(mesh2d)(TP.shard_gmm_states(gmm_np, mesh2d),
                                          torch.as_tensor(feats_tp[rows], device=dev))
    if tuple(ll_tp.shape) != (Btp // mesh2d.shape["data"], T, S):
        raise RuntimeError(f"TP score: shape {tuple(ll_tp.shape)}")
    cfg_tp = TrainConfig(nn_hidden=8 * n_model, nn_layers=2, lr=1e-3)
    mlp_tp = init_(build_model("mlp", S, cfg_tp, D), torch.Generator().manual_seed(7))
    tp_state = TP.init_tp_state(mlp_tp, mlp_tp.state_dict(), cfg_tp, mesh2d)
    lbl_tp = rng.integers(0, S, (Btp, T)).astype(np.int64)
    _, m = TP.make_tp_train_step(mlp_tp, cfg_tp, mesh2d)(
        tp_state, *(torch.as_tensor(a[rows], device=dev) for a in (feats_tp, np.full(Btp, T, np.int32), lbl_tp)))
    out["tp_shape"] = mesh2d.shape
    out["tp_loss"] = m["loss"]

    # --- pipeline parallel: GPipe over ('pipe',) ---
    pp_mesh = PP.make_pp_mesh(n, dev)
    pp_params = PP.shard_pp_params(PP.init_pp_params(torch.Generator().manual_seed(11), n, 8, S), pp_mesh)
    x_pp = torch.as_tensor(rng.standard_normal((3, 4, 8)).astype(np.float32), device=dev)
    y_pp = torch.as_tensor(rng.integers(0, S, (3, 4)), device=dev)
    _, out["pp_loss"] = PP.make_pp_train_step(pp_mesh, 3)(pp_params, x_pp, y_pp)

    # --- expert parallel: MoeAm, one expert a rank ---
    ep_mesh = EP.make_ep_mesh(n, dev)
    moe_cfg = TrainConfig(nn_arch="moe", nn_hidden=8, nn_layers=2, nn_context=1, nn_experts=n, num_nn_steps=4)
    moe = init_(build_model("moe", S, moe_cfg, D), torch.Generator().manual_seed(12))
    ep_state = EP.ep_opt_init(moe, moe_cfg, EP.shard_moe_am_params(moe, moe.state_dict(), ep_mesh))
    T_ep = 6
    x_ep = rng.standard_normal((n, T_ep, D)).astype(np.float32)
    y_ep = rng.integers(0, S, (n, T_ep)).astype(np.int64)
    _, m = EP.make_moe_am_ep_train_step(moe, moe_cfg, ep_mesh, capacity=T_ep)(
        ep_state, *M.shard_batch((x_ep, np.full(n, T_ep, np.int32), y_ep), ep_mesh))
    out["ep_loss"] = m["loss"]

    # --- sequence parallel: time-sharded front-end tail + a scorer ---
    sp_mesh = SP.make_sp_mesh(n, dev)
    Tsp = 8 * n
    base = rng.standard_normal((2, Tsp, D)).astype(np.float32)
    sp_params = {"W": torch.as_tensor(rng.standard_normal((3 * D, S)).astype(np.float32), device=dev),
                 "b": torch.zeros(S, device=dev)}
    logits = SP.make_sp_score_step(sp_mesh, _linear_scorer)(
        sp_params, torch.as_tensor(base[:, SP.time_block(Tsp, sp_mesh)], device=dev),
        torch.as_tensor([Tsp, Tsp - 5], device=dev))
    out["sp_shape"] = (2, Tsp, int(logits.shape[-1]))
    if tuple(logits.shape) != (2, Tsp // n, S):
        raise RuntimeError(f"SP: logits {tuple(logits.shape)}")

    end = _cuda.launch_counts()
    out["launches"] = {k: end[k] - start[k] for k in end}
    out["backend"] = mesh.backend
    return out


def dryrun_summary(n: int, r: dict) -> str:
    """The reference's summary line from a rank's values."""
    return (f"dryrun_multichip({n}) ok: em loglik={r['em_loglik']:.2f}, nn loss={r['nn_loss']:.3f}, "
            f"seq-mmi per-frame={r['mmi_per_frame']:.3f}, ctc loss={r['ctc_loss']:.3f}, "
            f"mpc loss={r['mpc_loss']:.3f}, distill loss={r['distill_loss']:.3f}, "
            f"rnnt loss={r['rnnt_loss']:.3f}, rnnt-pruned ok, aed loss={r['aed_loss']:.3f}, "
            f"mwer risk={r['mwer_risk']:.3f}, soft-em loglik={r['soft_loglik']:.2f}, "
            f"decode frames={r['decode_frames']}, tp score ok ({r['tp_shape']}), "
            f"tp mlp loss={r['tp_loss']:.3f}, pp loss={r['pp_loss']:.3f}, ep loss={r['ep_loss']:.3f}, "
            f"sp logits ok {r['sp_shape']}, dp lstm plain recurrence ok, mesh=('data',) x {n} ({r['backend']})")


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout_s: float = 600.0) -> list:
    """Every section over ``n_devices`` ranks (the card unless ``device``
    says otherwise; gloo when they share a card); prints the summary line and
    returns each rank's values."""
    from mogasr_torch.dist.launch import run_ranks

    results = run_ranks(_dryrun_rank, n_devices, device=device or "cuda", timeout_s=timeout_s,
                        args=(n_devices,))
    print(dryrun_summary(n_devices, results[0]), flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    path, score = fn(*ex)
    print("entry() forward ok:", tuple(path.shape), tuple(score.shape), flush=True)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()

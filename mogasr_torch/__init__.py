"""mogasr_torch: the PyTorch / CUDA port of mogasr for one NVIDIA H100.

The JAX package ``mogasr`` stays the reference; this package mirrors its
layout (``frontend/``, ``am/``, ``decoder/``, ``utils/``, ``pipeline.py``) so
each module's counterpart is easy to find. Nothing here imports ``mogasr``,
jax or flax: the reference's numpy-only modules that the port needs
(``config``, ``hmm/``, ``data/{batching,synthetic}``, ``eval/wer``,
``frontend/numpy_ref``, ``lm/{ngram,arpa}``,
``decoder/{lattice,confusion,kws}``) have their own copies here.

Device dispatch is by the tensor: a CUDA tensor goes through the hand-written
kernels in ``csrc/`` (built with nvcc at first use, see ``_cuda``), a CPU
tensor through the plain PyTorch versions beside them.

Exports are lazy so that ``import mogasr_torch`` stays light:

    mogasr_torch.load_system(path, device)      -> (GmmSet, topo, fcfg, tied, meta)
    mogasr_torch.make_frontend(cfg, max_samples, device)
    mogasr_torch.gmm_loglik_batched(feats, gmm, compute_dtype, mode, layout=...)
    mogasr_torch.viterbi(emit_ll, graphs, n_frames, acoustic_scale, beam, with_backtrace)
    mogasr_torch.decode_corpus(utts, gmm, graph, fcfg, dcfg, bcfg, device, compute_dtype, mode=..., layout=...)
    mogasr_torch.forward_backward(emit_ll, graphs, n_frames, acoustic_scale)
    mogasr_torch.train_gmm(batches, lexicon, topo, gcfg, tcfg, gmm=..., mode=...)
    mogasr_torch.init_gmm(cfg, generator, data_mean, data_var, device=...)
    mogasr_torch.corpus_wer(refs, hyps), ctc_loss(...), rnnt_loss(...), train_bpe(texts, n_merges)
    mogasr_torch.aed_decode_batch(model, feats, n_frames, ...), aed_stream_init(model, batch, n_feats),
    mogasr_torch.make_aed_stream_step(model)
    mogasr_torch.pipeline                       (the module)
    mogasr_torch.{Batch,Decode,Frontend,Gmm,Mesh,Pipeline,Topology,Train}Config

Every name the reference's ``mogasr/__init__.py`` exports resolves here;
``gmm_loglik_pallas``, its fused
scorer's name, is the K1 wrapper ``gmm_cuda.gmm_loglik_fused``.
"""

import torch

# Float32 GEMMs (the front end's DFT, mel and DCT, the plain GMM scorer) must
# run in true fp32 to keep parity with the NumPy oracle: TF32 keeps ~10
# mantissa bits and moves logliks by ~0.1 nats. cuDNN defaults to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_CONFIGS = ("BatchConfig", "DecodeConfig", "FrontendConfig", "GmmConfig", "MeshConfig", "PipelineConfig",
            "TopologyConfig", "TrainConfig")
# name -> module, or (module, attribute) where the names differ; a name that
# is its module's last component is the module
_EXPORTS = {
    **{name: "mogasr_torch.config" for name in _CONFIGS},
    "load_system": "mogasr_torch.utils.bundle",
    "make_frontend": "mogasr_torch.frontend.torch_frontend",
    "extract_features": "mogasr_torch.frontend.torch_frontend",
    "GmmSet": "mogasr_torch.am.gmm",
    "gmm_loglik": "mogasr_torch.am.gmm",
    "gmm_from_numpy": "mogasr_torch.am.gmm",
    "gmm_loglik_fused": "mogasr_torch.am.gmm_cuda",
    "gmm_loglik_batched": "mogasr_torch.am.gmm_cuda",
    "viterbi": "mogasr_torch.decoder.viterbi_cuda",
    "decode_corpus": "mogasr_torch.pipeline",
    "forward_backward": "mogasr_torch.decoder.fb_cuda",
    "train_gmm": "mogasr_torch.pipeline",
    "init_gmm": "mogasr_torch.am.gmm",
    "gmm_loglik_pallas": ("mogasr_torch.am.gmm_cuda", "gmm_loglik_fused"),
    "corpus_wer": "mogasr_torch.eval.wer",
    "ctc_loss": "mogasr_torch.am.ctc",
    "rnnt_loss": "mogasr_torch.am.rnnt",
    "aed_decode_batch": "mogasr_torch.am.aed",
    "aed_stream_init": "mogasr_torch.am.aed",
    "make_aed_stream_step": "mogasr_torch.am.aed",
    "train_bpe": "mogasr_torch.data.bpe",
    "pipeline": "mogasr_torch.pipeline",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'mogasr_torch' has no attribute {name!r}")
    import importlib

    module, attr = _EXPORTS[name] if isinstance(_EXPORTS[name], tuple) else (_EXPORTS[name], name)
    mod = importlib.import_module(module)
    return mod if module.rsplit(".", 1)[-1] == name else getattr(mod, attr)

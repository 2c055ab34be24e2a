"""Lexicon, HMM topology, graph building and triphone tying: the port's
copies of the numpy-only modules of mogasr/hmm, kept so that mogasr_torch
imports nothing of the JAX package."""

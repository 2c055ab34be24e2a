"""Synthetic corpus and utterance batching: the port's copies of
mogasr/data/{synthetic,batching}.py, kept so that mogasr_torch imports
nothing of the JAX package."""

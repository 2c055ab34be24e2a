"""Training recipes of the port (``python -m mogasr_torch.recipes.<name>``):
twins of the reference's ``benchmarks/`` training scripts."""

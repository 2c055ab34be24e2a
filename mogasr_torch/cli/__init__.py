"""Command-line entry points of the port (``python -m mogasr_torch.cli.<name>``):
twins of the reference's ``cli/`` scripts that run on the card."""

"""Batched serving: the session engines of ``serving/engine.py``."""

"""Atomic keep-last-k checkpoints (port of ``repro.checkpoint``)."""

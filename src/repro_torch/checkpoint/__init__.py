"""Fault-tolerant checkpoints (``manager``)."""

"""Checkpoints, run directories, summaries and small training helpers."""

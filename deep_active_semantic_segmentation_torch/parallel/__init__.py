"""Optimizers and the train / eval steps."""

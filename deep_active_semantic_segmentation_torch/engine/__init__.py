"""The trainer and the active-learning loop."""

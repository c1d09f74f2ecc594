"""Atomic checkpoints of the port's training state."""

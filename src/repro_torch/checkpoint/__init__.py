"""Atomic, async checkpoints of the training state (``checkpoint/store.py``)."""

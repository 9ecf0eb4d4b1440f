"""Synthetic batches and the prefetching loader (``data/pipeline.py``)."""

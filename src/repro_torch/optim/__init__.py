"""AdamW on the parameter tree (``optim/adamw.py``)."""

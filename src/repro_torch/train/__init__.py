"""Training-side utilities the port needs: atomic, retained, optionally
asynchronous checkpoints of nested numpy trees (``checkpoint.py``)."""

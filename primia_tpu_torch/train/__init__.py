"""Checkpoints (``checkpoint``), metrics (``metrics``) and the predict
step (``steps``)."""

"""Evaluation helpers: port of ``colxlip_tpu/training`` (scoring only so far)."""

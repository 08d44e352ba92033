"""Training and evaluation: port of ``colxlip_tpu/training``."""

"""Batched HTTP inference server: port of ``colxlip_tpu/serving``."""

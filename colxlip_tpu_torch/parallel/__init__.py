"""The train step and data parallelism: port of ``colxlip_tpu/parallel``."""

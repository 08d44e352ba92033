"""The train step: port of ``colxlip_tpu/parallel`` (one device so far)."""

"""Batched HTTP inference server, retrieval index and int8 encoders: port of
``colxlip_tpu/serving``."""
from .int8 import (  # noqa: F401
    quantize_text_params,
    quantize_vision_params,
    text_encode_int8,
    vision_encode_int8,
)

"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at the full
700 W power limit. A card set below it runs slower under load: every result
line carries the card's name beside the numbers."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

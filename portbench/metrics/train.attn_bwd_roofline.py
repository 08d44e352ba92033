"""train.attn_bwd_roofline (%): the attention backward kernels (csrc/fused_attention_bwd.cu, dQ and dK/dV passes): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "attention_bwd", view.kernel_seconds(readers.ATTN_BWD))

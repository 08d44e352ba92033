"""train.attn_fwd_roofline (%): the attention forward kernel (csrc/fused_attention.cu): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "attention_fwd", view.kernel_seconds(readers.ATTN_FWD))

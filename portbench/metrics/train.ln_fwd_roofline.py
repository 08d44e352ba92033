"""train.ln_fwd_roofline (%): the LayerNorm forward kernel (csrc/fused_ln.cu): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "layernorm_fwd", view.kernel_seconds(readers.LN_FWD))

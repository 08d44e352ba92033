"""train.mlp_fwd_roofline (%): the MLP forward tiles (csrc/fused_mlp.cu, epilogues GELU and bias): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "mlp_fwd", view.kernel_seconds(readers.MLP_FWD))

"""train.ln_bwd_roofline (%): the LayerNorm backward kernels (csrc/fused_ln.cu
row kernel and the partial reduce it launches next, which the MLP backward
shares): the least time the traced steps' launches could take over their
device seconds."""
from portbench import readers


def read(view, window, cell):
    seconds = view.attributed_seconds(readers.LN_BWD, readers.SHARED_REDUCE, readers.MLP_BWD)
    return readers.roofline(view, window, cell, "layernorm_bwd", seconds)

"""train.mlp_bwd_roofline (%): the MLP backward tiles (csrc/fused_mlp.cu
epilogues pre, dh, round and accumulate, the column sums, and the partial
reduce they launch next): the least time the traced steps' launches could
take over their device seconds."""
from portbench import readers


def read(view, window, cell):
    seconds = view.attributed_seconds(readers.MLP_BWD, readers.SHARED_REDUCE, readers.LN_BWD)
    return readers.roofline(view, window, cell, "mlp_bwd", seconds)

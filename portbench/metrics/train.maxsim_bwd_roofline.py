"""train.maxsim_bwd_roofline (%): the MaxSim backward kernels (csrc/maxsim_bwd.cu): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "maxsim_bwd", view.kernel_seconds(readers.MAXSIM_BWD))

"""train.maxsim_fwd_roofline (%): the MaxSim forward kernels (csrc/maxsim.cu): the least
time the traced steps' launches could take (yardstick/bounds.py, at the
configuration's shapes) over the device seconds of the kernels matched by
name."""
from portbench import readers


def read(view, window, cell):
    return readers.roofline(view, window, cell, "maxsim_fwd", view.kernel_seconds(readers.MAXSIM_FWD))

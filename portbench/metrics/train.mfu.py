"""train.mfu (%): the model FLOPs of the traced steps (yardstick/flops.py,
no recomputation) over the traced window's seconds, over the card's bf16
peak."""
from portbench import readers


def read(view, window, cell):
    return readers.mfu(view, window, cell)

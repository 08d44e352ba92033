"""embed.idle_share (%): the share of the traced window in which no device
operation runs."""
from portbench import readers


def read(view, window, cell):
    return readers.idle_share(view)

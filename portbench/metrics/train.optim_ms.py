"""train.optim_ms (ms): device milliseconds a step in the AdamW foreach
kernels (multi_tensor_apply)."""
from portbench import readers


def read(view, window, cell):
    steps, seconds = readers.per_step(window), view.kernel_seconds(readers.OPTIMIZER)
    return 1e3 * seconds / steps if steps and seconds > 0 else None

"""train.gemm_ms (ms): device milliseconds a step in library matrix products
(cuBLAS / CUTLASS kernels matched by name; the MLP tiles excluded)."""
from portbench import readers


def read(view, window, cell):
    steps, seconds = readers.per_step(window), readers.library_gemm_seconds(view)
    return 1e3 * seconds / steps if steps and seconds > 0 else None

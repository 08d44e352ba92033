"""colxlip_tpu_torch: the PyTorch + CUDA port of colxlip_tpu for NVIDIA Hopper.

The JAX package ``colxlip_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``data/``, ``ops/``, ``training/``, ``serving/``) so
each counterpart is easy to find. It imports ``torch`` and never ``jax``:
``import colxlip_tpu`` pulls in jax and flax, so the pure-Python helpers it
needs (configs, tokenizer, transforms) are ported here rather than imported.

The serving path is ported: ``serving/server.py`` runs both towers and the
``/v1/score`` MaxSim on one GPU through two hand-written CUDA kernels
(``csrc/fused_attention.cu``, ``csrc/maxsim.cu``).
"""

__version__ = "0.1.0"

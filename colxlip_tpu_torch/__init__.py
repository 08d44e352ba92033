"""colxlip_tpu_torch: the PyTorch + CUDA port of colxlip_tpu for NVIDIA Hopper.

The JAX package ``colxlip_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``data/``, ``ops/``, ``training/``, ``serving/``) so
each counterpart is easy to find. It imports ``torch`` and never ``jax``:
``import colxlip_tpu`` pulls in jax and flax, so the pure-Python helpers it
needs (configs, tokenizer, transforms) are ported here rather than imported.

Ported so far, on one GPU: the serving path (``serving/server.py``: both
towers and the ``/v1/score`` MaxSim), the train step
(``parallel/train_step.py``: both towers forward and backward, the
``colclip`` / ``clip`` losses, AdamW) and the training entry point
(``python -m colxlip_tpu_torch.main``: flags, synthetic data, the epoch loop,
checkpoints, resume, preemption). The TPU kernels on those paths are
hand-written CUDA kernels (``csrc/``): packed-QKV attention and MaxSim,
forward and backward, and the streaming contrastive CE (forward, dA, dB)
behind ``--ce-impl fused``, all under ``torch.autograd.Function``s. Later
slices added the fused towers, int8 and corpus search, eval, the tar feed,
data parallelism, and the other loss families: SigLIP, distillation and
CoCa, with captioning behind ``/v1/caption``; then the pod step, sharded
state and tensor parallelism (``parallel/gspmd.py``), ``--remote-sync``
(``utils/file_utils.py``), the ``torch.export`` serving bundle
(``serving/aot.py``) and the pretrained tags (``pretrained.py``).
"""

__version__ = "0.1.0"

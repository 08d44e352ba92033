#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (colxlip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines; any failure raises (non-zero exit):

  1. device: requires torch.cuda.is_available(); prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles colxlip_tpu_torch/csrc/*.cu with nvcc for sm_90a (one
     nvcc per source, all at once); meanwhile a second nvcc -Xptxas -v of the
     attention, MaxSim, MLP, CE and LayerNorm sources reads each kernel's
     registers and spills (printed in phase 5).
  3. kernels: first a bare 64 x 64 x 64 product through the tensor-core tile
     code (csrc/mma_tile.cuh) against torch.matmul, A . B^T, its rounded
     result times B, and A^T . B from k-major tiles; then each forward kernel
     against its plain PyTorch version at the serving shapes, and each
     backward kernel against its plain version at the training shapes (batch
     256) in fp32 and bf16, with the tolerances below; the attention kernels
     also at ViT-L/14's 257 tokens (bf16 and fp32), at 1024 tokens under the
     causal mask and at a ragged head_dim-32 shape, and two runs of the
     attention backward at the vision shape must agree bit for bit; the
     MaxSim forward in fp32 at the serving shape (64 x 64) and in fp32 and
     bf16 at the training shape (256 x 256, the main path's) and at 100 text
     against 577 image tokens (ViT-L/14 at 336 px), the MaxSim backward at
     both shapes, two of its runs bit for bit; the
     three streaming-CE kernels (forward, dA + dscale, dB) in
     fp32 and bf16 at M = N = 256 and 4096 (D = 512), M = 33, N = 129
     (D = 64) and M = N = 1024 with b = a, in bf16 at M = N = 1024 with
     b = a at logit scale 100 ("tied-100", held: the bf16 forward and
     backward take their logits from one tensor-core tile), at M = N = 4096
     with D = 768 and at M = N = 32768, where the dense fp32 logits
     would be 4 GiB: the kernel path's peak memory there is printed and
     bounded, and two runs of the backward must agree bit for bit. The
     LayerNorm and MLP kernels (forward and backward each) in fp32 and bf16
     at the training shapes (batch 256, vision and text), the token-head
     LayerNorm shape and one ragged shape each, and the LayerNorm (both
     types) and the MLP (bf16, and fp32 in two feature slices:
     MLP_FP32_WIDE, timed in phase 5 beside its plain version, the three
     library calls in fp32 and its bound) at ViT-L/14's width (D 1024, H
     4096, 16 x 257 rows), as phase 8b runs them; the bf16 MLP forward per element against
     the exact function (ops/fused_mlp_check.py), and at the vision shape two
     controls that must fail that bar; two runs of each
     backward must agree bit for bit, and at the vision shape neither
     direction of the MLP may hold as much as one [B, N, H] tensor above its
     inputs.
     The stochastic-rounding int8 quantizer (3e) at every Dense shape of the
     model, one ragged shape, one with an all-zero column and a column
     whose extremes sit at +-absmax, and two slices too tall for a cluster's
     shared memory (ViT-L-14's [4096, 1024], K = 16,384), fp32 and bf16,
     seeds 0 and 1: values and
     scales equal to the plain version's bit for bit, one seed twice equal,
     two seeds different, scales equal to round-to-nearest's and values
     within one step of it, and unbiased over 64 seeds.
  4. serving slice: ColXLIPService (ViT-B-16-colxlip, full width, random
     init from seed 0, bf16 compute) behind make_server on an ephemeral
     port, driven over HTTP; checks finite unit-norm embeddings, that both
     forward kernels were launched by the requests, and the /v1/score
     matrices against a plain-path recomputation on the same device.
  5. timings (CUDA events, after warm-up): each kernel against its plain
     version (the MaxSim kernels also pass by pass, torch.profiler), and
     against the one PyTorch call that computes the same
     function where there is one (scaled_dot_product_attention, forward and
     backward, at the vision shape and at ViT-L/14's; for the streaming CE the pair torch.matmul + F.cross_entropy
     over the dense logits is timed beside it; F.layer_norm forward and
     backward beside the LayerNorm kernels; the three calls F.linear,
     F.gelu, F.linear and their autograd backward beside the MLP kernels, at
     every MLP case, each with its bound; the LayerNorm backward at vision,
     text, token-head and ViT-L/14's width, its row kernel and partial-row
     reduce apart (torch.profiler) beside torch.add(x, dy),
     which moves the same bytes; the CE forward at M = N = 256, 4096 and
     32768 beside its plain version and the dense pair; the quantizer's call,
     its host side apart and its device side, which must be one kernel a
     call, torch.profiler);
     encode throughput at batch 64, request latency; the attention bounds
     at the text shape as well. The library calls are
     timed only: on the paths timed here the port never calls them.
  6. train slice: make_train_step on ViT-B-16-colxlip (full width and depth,
     seed 0, fp32 parameters, bf16 compute), colclip loss (alpha 0.5, mask
     'nonzero'), AdamW with a cosine schedule, batch 256 of seeded synthetic
     images and token ids, TRAIN_STEPS steps on one fixed batch; checks that
     every loss is finite and the loss falls, that every forward and
     backward kernel was launched by the steps, and (at batch 64) the step's
     losses and gradients against the same step through the plain versions;
     times the step (ms, img/s), reads the peak device memory, and prints
     the device time of one more step by kernel (torch.profiler) with the
     device's idle share of that step.
     Then (6b) ViT-L-14-colxlip at full width and depth (24 + 12 blocks, 257
     image tokens, seed 0, bf16): encode_image / encode_text at batch 16
     against the same weights through the plain attention, and 2 colclip
     train steps at batch 16 (finite falling loss, one attention launch a
     block forward and backward, one MaxSim launch each way).
     Then (6c) phase 6's step with COLXLIP_LN_IMPL=fused alone (the
     LayerNorm kernels in both towers, the MLPs on the library path),
     TRAIN_STEPS steps on the same batch and schedule: exact launch counts,
     falling loss, the step's ms and peak beside phase 6's, one profiled step.
  7. training entry point: colxlip_tpu_torch.main.main([...]) in process,
     ViT-B-16 (full width and depth, clip loss) with --dataset-type
     synthetic --batch-size 256 --precision bf16 --ce-impl fused, 2 epochs
     of 6 steps with fresh batches from the prefetch threads, a checkpoint
     per epoch, and --retrieval-flickr --val-frequency 1 (global scoring) on
     the vendored Flickr30k val annotations with a seeded JPEG written at
     each image path (1,014 images of 256-500 px, 5,070 captions); checks
     the return code, that every logged loss is finite and the first is near
     ln 256, that epoch_1, epoch_2, params.txt, out.log and metrics.jsonl
     exist, that results.jsonl holds an eval line for each epoch, and that
     the steps and evals launched the three CE kernels (two each a step) and
     the attention kernels exactly; then --epochs 3 --resume latest must go
     on from epoch_2, write epoch_3 and a third eval line. Prints the step's
     ms and samples/s, data_time, the peak device memory, the device's idle
     share over three profiled steps and the eval's R@k and time split.
  8. the towers through the LayerNorm and MLP kernels: with
     COLXLIP_LN_IMPL=fused and COLXLIP_MLP_IMPL=fused set before the model
     is built, ViT-B-16-colxlip (full width and depth, seed 0, bf16):
     encode_image / encode_text at batch 64 against the same weights through
     the default path, a uint8 batch against the same batch normalised on
     the host, FUSED_STEPS colclip train steps at batch 256 on one fixed
     batch (finite falling losses, the launch counts of all eight kernels on
     the path exact), the batch-64 step through the kernels against the same
     step through the plain versions in fp32 and bf16, and the step's ms,
     img/s and peak device memory beside phase 6's: the peak must fall by
     the hidden tensors the default path keeps for autograd, and the step
     may take at most FUSED_STEP_RATIO_MAX times phase 6's; then the device
     time of one more step by kernel and the device's idle share
     (torch.profiler). Then (8b) ViT-L-14-colxlip the same way at batch
     VIT_L_BATCH (the LayerNorm backward at D = 1024): both encoders against
     the default path on the same weights, VIT_L_STEPS train steps with exact
     launch counts, and the peak below phase 6b's; then one fp32 step of it
     through both kernels (the MLP kernels past D = 768 in their feature
     slices): 79 LayerNorm, 36 MLP and 36 attention launches each way, its ms
     and peak, and the step against the plain versions under phase 6's fp32
     bars.
  9. the int8 slice, full width and depth, seed 0: (a) every Dense weight of
     both towers through the quantizer kernel (99 launches, timed) and through
     round-to-nearest (quantize_vision_params / quantize_text_params);
     (b) vision_encode_int8 / text_encode_int8 at batch 64 with either set of
     weights against the bf16 model (cosine of every row above 0.99, 12
     attention launches an encode, a uint8 batch finite and unit-norm), img/s
     and txt/s beside the bf16 model's; (c) maxsim(impl='streaming_int8') on
     the model's token features at 64 x 64 and 256 x 256 against the default
     forward, zero rows, its backward against the default backward, and one
     colclip train step at batch 256 with maxsim_impl='streaming_int8'
     against the default step; (d) /v1/search over HTTP on an index of 2,048
     seeded images built with build_image_index: ids and scores against a
     recomputation with score_similarity, shortlist 2,048 against brute
     force, launch counts, latency and build img/s.
 10. eval, ViT-B-16-colxlip (full width and depth, seed 0, bf16) saved as a
     .pt and evaluated by colxlip_tpu_torch.main.main([...]) in its eval-only
     mode with --retrieval-flickr --eval-scoring mixed on the same 5,070
     texts and 1,014 images: the attention kernel launched exactly 12 times
     an encode batch a tower, the MaxSim forward (fp32) once, no backward
     kernel; the similarity matrix within 2e-2 x logit_scale of the same
     weights through the plain versions on the card; results.jsonl equal to
     the reference loop oracle on that matrix, exactly; both runs' R@k, the
     eval's wall seconds and its split (host image load and transform, image
     encode, text encode, score, metrics); the MaxSim forward at the eval
     shape beside its plain version and bound; the attention kernel's share
     of an encode batch's device time (torch.profiler); then zero-shot with
     the full 1,000 x 80 classifier over a seeded folder of one image a
     class, with its attention launch count.
  11. the tar path: 8 WebDataset shards of 384 seeded samples
     (colxlip_tpu_torch/data/shard_writer.py: JPEGs 512 px on the shorter
     side and 512-768 on the longer at quality 95, as the reference's scrape
     keeps them, with the recaption JSON), written by a thread pool; then
     ViT-B-16-colxlip (full width and depth, seed 0, bf16, colclip) trained
     by colxlip_tpu_torch.main.main([...]) at batch 256 with --workers
     min(8, cpu count) in three feeds: (a) PIL decode and the float32 feed,
     2 epochs cut at 6 steps; (b) --normalize-on-device --packed-feed, with
     --native-decode where a probe finds jpeglib.h and -ljpeg (the printed
     line says which), 2 x 6 steps; (c) --ship-format yuv420 --packed-feed,
     6 steps. Each: rc 0, finite losses, the first within 0.5 of phase 6's,
     launches exact (24 attention each way and one MaxSim each way a step;
     no LayerNorm, MLP or CE launch), the median step and data_time of
     steps 3 onward, the idle share of the profiled steps, host-to-device
     bytes a step, peak memory, and the pipeline alone (no model) over 6
     batches. A batch of (b) packed, copied and unpacked on the card equals
     the host batch bit for bit; (c)'s decode on the card is within 2e-4 of
     the numpy reference; with the native decoder, 16 samples are within an
     RMS of 12 pixel units of the PIL transform on the same boxes.
  12. data parallelism: a torch.distributed process group of one on the card
     (NCCL; it refuses two ranks on one GPU). (a) make_train_step(mesh=group)
     on ViT-B-16-colxlip, bf16, batch 256, in four modes: colclip full mode,
     colclip --local-loss, colclip --local-loss --token-dist ring
     --token-neighborhood 2, clip --local-loss --ce-impl fused (the
     local-loss modes with --gather-with-grad), each against the one-device
     step on the same weights and batch: full mode bit-equal in every metric
     and gradient; the others within DIST_LOSS_TOL in the losses and, with
     gradients, in fp32 compute under STEP_TOL's fp32 bar (every cosine at
     least 0.9999, norms within 1e-3) and in bf16 under its bf16 bar (two
     MaxSim calls round dT and dI to bf16 apart where one device rounds
     once); launches exact (MaxSim twice a step under local loss, each CE
     kernel twice a step in the clip mode); each mode's ms a step and peak
     beside the one-device step's and phase 6's, and one profiled step of
     full mode each way. (b) the name and
     resume-path broadcast, the stop consensus, the barrier, the gradient
     all-reduce and the parameter broadcast, once each under the group with
     tensors on the card. (c) #5 and #6 at T 256 x I 1024 and T 1024 x I 256 (77 x 197
     tokens, D 512, bf16) and #11-13 at M 256, N 1024, D 512 with labels
     offset by 768 (bf16, fp32), against their plain versions with phase
     3's tolerances, timed beside them and their bounds.
  13. the other loss families, each through colxlip_tpu_torch.main.main([...])
     in process on one seeded synthetic batch of 256 (--train-num-samples
     256: each of 6 epochs is one step on that batch), bf16, no saves:
     (a) ViT-B-16 --siglip; (b) ViT-B-32 distilled from a ViT-B-16 teacher
     that the port writes first as a seeded .pt (save_pt_checkpoint;
     --distill-model / --distill-pretrained); (c) coca_ViT-B-32 (full width
     and depth) under --ce-impl dense and fused. Each: rc 0, finite losses
     (SigLIP's and CoCa's contrastive and caption terms falling), attention
     launches exact a step (24 forward and 24 backward; distillation 48
     forward, the teacher's 24 with no backward; CoCa the vision tower's 12
     and the decoder's 12, its text tower and every cross-attention on the
     library path) and no other kernel; the teacher's state dict bit-equal to
     its .pt after the run; each step's ms, img/s and peak timed apart on a
     device-resident batch at learning rate 0, the fused CoCa peak below the
     dense one and their caption losses on one batch within
     CAPTION_FUSED_TOL; the batch-64 SigLIP and CoCa steps against the plain
     versions under phase 6's bf16 bars. (d) coca_ViT-B-32 served over HTTP:
     /v1/caption greedy on 8 seeded JPEGs answers 8 strings, those of
     generate_captions' tokens, with 12 + 12 x 75 attention launches (the
     image once, then 75 decode steps of the decoder); the bf16 tokens beside
     the plain versions' (rows that agree, printed), the first step's logits
     within phase 4's encode bars of theirs; in fp32 the tokens equal the
     plain versions'; request ms at batch 8 and 64 and ms a decode step.
  14. the pod recipes' per-device step (colxlip_tpu_torch/parallel/pod_shape.py:
     one device's share of --local-loss --token-dist ring --token-neighborhood 8
     --gather-with-grad across M = 64 devices, the transport left out, the
     remote blocks rolled copies of the local ones): ViT-B-16-colxlip, bf16,
     batch 256, alpha 0.7, in both window modes ('scan': 8 MaxSim calls a
     direction; 'fused': one over the [8 x 256] window) at 77 text tokens and
     'scan' at the recipes' --text-ctx 64, and ViT-L-14-colxlip at the
     recipe's batch 64 'scan' (halved until it fits, the cut printed). Each:
     POD_STEPS steps at learning rate 0 on one device-resident batch,
     launches a step exact (24 / 24 attention, 36 / 36 at ViT-L; 16 / 16
     MaxSim under 'scan', 2 / 2 under 'fused'), ms a step (median of steps
     2-4, host clock ending in synchronize()), img/s, peak, and one profiled
     step's MaxSim share of the device time. The batch-64 step at M 8, K 4
     against the plain versions under phase 6's bars (fp32 and bf16), 'scan'
     against 'fused' in fp32 (losses within 1e-5), and #5 / #6 at the fused
     window's T 256 x I 2048 and T 2048 x I 256 against their plain versions,
     timed beside them and their bounds.
  15. saves and precision through main: (a) ViT-B-16 with --async-checkpoint
     --save-frequency 1 --save-most-recent --delete-previous-checkpoint, 3
     epochs of 2 steps at batch 256; before each async save the same state is
     saved synchronously into a side directory (timed), and each async
     epoch_N and epoch_latest must load bit-equal to it; rc 0, the rotation's
     directories, then --epochs 4 --resume latest goes on at step 7; the
     resumed run's state on the card saved synchronously, async with the host
     snapshot and async with the device snapshot: the blocking snapshot, the
     background write and the synchronous save in seconds, apart, the three
     files bit-equal. (c) --remote-sync s3://bucket/runs through a stand-in
     aws on PATH (AWS_STUB: the bucket is a local directory): 2 epochs of 2
     steps with one save, synced at startup and after the save; a fresh log
     directory with --resume latest pulls epoch_2 and goes on at step 5; the
     sync and pull seconds. (b) ViT-B-16-colxlip --precision pure_bf16 through main
     (6 epochs of one step on one batch of 256): rc 0, the loss falls,
     launches as phase 6 (24 / 24 attention, 1 / 1 MaxSim a step); the step's
     ms and peak timed apart beside the same step with fp32 parameters and
     phase 6's.
  16. sharded state (colxlip_tpu_torch/parallel/gspmd.py) under a NCCL group
     of one (NCCL refuses two ranks on one GPU): ViT-B-16-colxlip, colclip,
     alpha 0.5, mask 'nonzero', bf16, batch 256, gather with gradient, from
     phase 6's weights. (a) shard_state + make_train_step_gspmd(fsdp=True) on
     a ('data',) mesh of one: FSDP2's all-gathers and reduce-scatters at
     size one; 4 steps, the first against the one-device step (losses to
     1e-5, the gradients to phase 6's bf16 bars; bit-equality printed), the
     rest timed at learning rate 0; 24 / 24 attention and 1 / 1 MaxSim
     launches; ms, img/s, peak and idle beside phase 6's. (b) the same on a
     ('data', 'model') mesh of 1 x 1: the DTensor parameters, the in_proj
     regroup and the model-axis collectives around kernels #1 and #2 at size
     one, same bars; again under COLXLIP_LN_IMPL=fused
     COLXLIP_MLP_IMPL=fused (55 / 24 launches, the MLP's row-parallel bias
     added after the sum) against the one-device fused step under phase 6's
     bf16 bars. (c) (a)'s state (150.3 M parameters and the AdamW moments)
     through save_checkpoint_sharded into $TMPDIR, synchronous and in the
     background: seconds beside phase 15's save, a restore into a fresh
     sharded state bit-equal, load_native_checkpoint of the directory equal
     to the state whole. (d) main --fsdp at one process returns 1 before
     any model work, with the JAX entry point's words. (e) the TP plan of (b)
     under COLXLIP_MLP_INT8=fwd against the one-device int8 step (c_proj
     takes the model group's scales and sums its int32 products), launches
     as (a). (f) coca_ViT-B-32 (coca loss, batch 256) under the TP plan and
     under FSDP against the one-device CoCa step: 24 / 24 attention
     launches, losses to 1e-5, gradients to phase 6's bf16 bars (a gradient
     under 1e-4 of the largest held by its difference); ms, peak, idle.
  17. the serving bundle (colxlip_tpu_torch/serving/aot.py on torch.export):
     ViT-B-16-colxlip's towers exported on the card with a symbolic batch,
     saved and loaded back; batches of 1, 8 and 64 against the live model
     within phase 4's encode bars; img/s and txt/s at 64 beside the live
     model's; the export seconds and bytes; kernel #1 launches 0 times inside
     the bundle (SDPA under export, as the JAX dispatch) and is printed.
  Phases 4, 6, 7, 10, 11, 12, 13, 14, 15 and 16's default runs use the
  default path and must launch none of the LayerNorm and MLP kernels.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi name and power limit, and before that one JSON object with the
per-kernel results: for each kernel its launches on its path (counters set
to 0 just before the path is driven), its largest error against the plain
version, its time beside the plain version's, the library call's (or null)
and the bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for the input type (989 TFLOP/s bf16, 67
TFLOP/s fp32; NVIDIA's H100 SXM data sheet).
"""
from __future__ import annotations

import base64
import contextlib
import copy
import io
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

MODEL = "ViT-B-16-colxlip"
MAX_BATCH = 64
# kernel vs plain version on the same inputs:
#   fp32: summation order only (1e-5 absolute on outputs of magnitude < ~3);
#   bf16: the output is rounded to bf16 (2^-8 relative), so one rounding
#         step apart on |out| < 1 is < 4e-3.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# MaxSim scores of unit-norm tokens, in [-1, 1], fp32 and bf16 inputs alike: a
# bf16 product is exact in fp32, and fp32 inputs take fp32 products, so only
# the summation order differs
MAXSIM_TOL = 1e-5
# MaxSim token counts the first kernels refused: ViT-L/14 at 336 px with its
# CLS token (577 image tokens), 100 text tokens, ViT-L's width; M = K = 16
MAXSIM_LONG = (16, 100, 577, 768)
# /v1/score (kernels) vs a plain-path recomputation: both run the model in
# bf16, so the kernels' and the plain versions' roundings differ at 2^-8
# relative per step through 12 layers; bound the cosine-level drift at 2e-2
SCORE_TOL_PER_UNIT_SCALE = 2e-2
# encode_image / encode_text through the LayerNorm and MLP kernels vs the
# default path on the same weights, bf16: the compared elements are unit-norm
# 512-d features, typically 1/sqrt(512) = 0.044 and at most a few tenths, so
# the score's bar would be half a typical value. The two paths differ by bf16
# roundings through 12 layers, which read 5e-3 on the largest elements; a
# LayerNorm or MLP wrong by a tenth in one layer moves whole rows by more.
# Two bars: 1e-2 on any element, and 1e-3 on 1 - cosine of any unit-norm row
# (a row whose every element is off by 5e-3 / sqrt(512) rms has 2.5e-5).
ENCODE_TOL = 1e-2
ENCODE_COSINE_TOL = 1e-3
# backward kernels vs their plain versions, relative to the largest |grad|:
#   fp32: summation order only (1e-5);
#   bf16: each gradient is summed in fp32 and rounded to bf16 once, and the
#         attention backward rounds dz and p to bf16 on the way, where the
#         two versions may land one step apart: 2^-7 (two bf16 steps).
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# streaming-CE kernels vs their plain versions:
#   loss rows and lse: |got - want| / (1 + |want|) <= 1e-5 (fp32 sums of the
#     products in another order; a bf16 x bf16 product is exact in fp32);
#   dA, dB, dscale: 1e-4 of the largest |grad| (expf against torch.exp at
#     1e-7 relative, summed over up to 32768 terms at logits up to 100).
CE_FWD_TOL = 1e-5
CE_BWD_TOL = 1e-4
CE_CASES = [
    # M, N, D, logit scale, dtypes, b = a, seed: None draws from the phase's
    # one generator; a case added later has a generator of its own, so that
    # adding it changes the inputs of no other check
    (256, 256, 512, 1 / 0.07, ("float32", "bfloat16"), False, None),     # one step of phase 7
    (33, 129, 64, 30.0, ("float32", "bfloat16"), False, None),
    (4096, 4096, 512, 100.0, ("float32", "bfloat16"), False, None),
    (4096, 4096, 768, 100.0, ("bfloat16",), False, None),  # ViT-L-14's embed_dim, the widest D
    # b = a: each row's own column is its largest logit (p near 1) beside a
    # label term near -g, so dz's two largest terms cancel in every row
    (1024, 1024, 512, 1 / 0.07, ("float32", "bfloat16"), True, None),
    # "tied-100": b = a at the scale's clamp, each row's own logit about 100;
    # holds because the bf16 forward and backward take raw from one logit tile
    (1024, 1024, 512, 100.0, ("bfloat16",), True, 100),
    (32768, 32768, 512, 100.0, ("bfloat16",), False, None),     # dense logits: 4 GiB
]
CE_PEAK_LIMIT_GIB = 1.0     # kernel path at 32768, above its inputs
# LayerNorm and MLP kernels vs their plain versions:
#   forward, of max(1, largest |out|): fp32 1e-5 (the sums run in another
#     order, 3072 terms deep in the MLP, and rsqrtf / expf / tanhf stand
#     against torch's); bf16 LayerNorm 2^-7 (the output is rounded to bf16
#     once: one step of the largest value). The bf16 MLP forward rounds four
#     times and sums in its own order: it is held per element to the exact
#     function within what its fp32 sums and GELU allow
#     (colxlip_tpu_torch/ops/fused_mlp_check.py derives the bar), and two
#     controls must fail that bar (MLP_CONTROL_ROWS);
#   backward, of the largest |grad|: fp32 1e-4 (dscale, dbias, dW and db sum
#     50,432 rows in another order); bf16 2^-7 (dx is rounded to bf16 once,
#     and a dh or a that lands one bf16 step apart moves a weight gradient by
#     far less).
FUSED_FWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FUSED_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# rows of the vision case through the first control (K sums kept in bf16)
MLP_CONTROL_ROWS = 2048
LN_CASES = [
    # name, leading shape, D, seed (None: the phase's one generator; a case
    # added later has a generator of its own, as in CE_CASES)
    ("vision", (256, 197), 768, None),
    ("text", (256, 77), 512, None),
    ("token-head", (256, 196), 512, None),
    ("ragged", (197 * 3,), 512, None),
    ("vit-l", (16, 257), 1024, 1024),   # phase 8b's width: the PE = 32 bucket
]
MLP_CASES = [
    # name, B, N, D, H, the GELU branches checked, dtypes
    ("vision", 256, 197, 768, 3072, (False,), ("float32", "bfloat16")),
    ("text", 256, 77, 512, 2048, (False,), ("float32", "bfloat16")),
    ("ragged", 3, 77, 512, 2048, (False, True), ("float32", "bfloat16")),
    ("vit-l", 16, 257, 1024, 4096, (False,), ("bfloat16",)),
]
# float32 past D = 768 (the feature slices of csrc/fused_mlp.cu): ViT-L/14's
# MLP, as phase 8b's fp32 step runs it; a generator of its own (seed 1024),
# so that no other check's draw moves
MLP_FP32_WIDE = ("vit-l", 16, 257, 1024, 4096, 1024)
# the fused-towers step (phase 8) against the default step (phase 6): at most
# this many times its time (the bf16 MLP kernels on the tensor cores)
FUSED_STEP_RATIO_MAX = 2.0
FUSED_STEPS = 4
# launches of one colclip train step of ViT-B-16-colxlip through the kernels:
# LayerNorm: vision ln_pre + 12 x (ln_1, ln_2) + ln_post + 2 in its token
# head = 28, text 12 x 2 + ln_final + 2 in its head = 27; one MLP and one
# attention call a block, 12 blocks a tower; one MaxSim. Forward and backward
# alike.
STEP_LAUNCHES = {"fused_ln": 55, "fused_mlp": 24, "fused_attention": 24, "maxsim": 1}
ENCODE_LN_LAUNCHES = {"image": 28, "text": 27}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TRAIN_BATCH = 256
TRAIN_STEPS = 10
MAIN_MODEL = "ViT-B-16"
MAIN_STEPS_PER_EPOCH = 6
COMPARE_BATCH = 64
# phase 6b: the model whose 257 image tokens the first attention kernels refused
VIT_L_MODEL = "ViT-L-14-colxlip"
VIT_L_BATCH = 16
VIT_L_STEPS = 2
# attention cases beyond the two towers' shapes: name, B, N, H, D, causal, dtypes
ATTN_EXTRA_CASES = [
    ("vit-l", 8, 257, 16, 64, False, ("bfloat16",)),        # one live key in the fifth tile
    ("vit-l-fp32", 2, 257, 16, 64, False, ("float32",)),
    ("long-causal", 2, 1024, 4, 64, True, ("bfloat16",)),   # 16 key tiles, most skipped
    ("ragged-d32", 3, 65, 4, 32, True, ("bfloat16",)),
]
# the bare tile product against torch.matmul: fp32 sums of exact bf16 products
# in another order (values up to about 30); the second product reads the first
# rounded to bf16, where the two may land one step apart (2^-8 relative a term)
MMA_TILE_TOL = (1e-4, 2.0 ** -6)
# the train step through the kernels vs through the plain versions (batch
# 64, same weights and inputs), per gradient tensor: (min cosine, max
# relative norm difference) and the max relative difference of the losses.
#   fp32 compute: the kernels and the plain versions differ by summation
#     order only (1e-7 relative per call), grown through 12 layers of each
#     tower and the backward: cosine >= 0.9999, norms and losses 1e-3.
#   bf16 compute: the two round bf16 intermediates at different places, and
#     the differences compound through the towers; the LayerNorm-bias
#     gradients are sums over 12,544 tokens with heavy cancellation, whose
#     direction moves by about 1e-2 between two roundings (cosine 0.991 for
#     vision_token_layer.0.bias in the first run on the H100). So: cosine
#     >= 0.98, norms 5e-2, losses 1e-2.
STEP_TOL = {"float32": (0.9999, 1e-3, 1e-3), "bfloat16": (0.98, 5e-2, 1e-2)}
# a per-tensor gradient whose norm is under this share of the step's largest
# is compared by its difference (under the same share), not by its direction
VANISHING_GRAD = 1e-4


# the quantizer kernel: every distinct Dense shape of ViT-B-16-colxlip as
# [K, N] = [in, out], and one ragged shape (N not a multiple of 4)
QUANT_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 512), (512, 1536),
                (512, 512), (512, 2048), (2048, 512), (197, 129)]
# slices too tall for a cluster's shared memory, read again from L2 in the
# same launch: ViT-L-14's c_proj [4096, 1024] and a K of 16,384 (own seed, so
# that no other check's draw moves)
QUANT_TALL_SHAPES = [(4096, 1024), (16384, 512)]
QUANT_TALL_SEED = 14
QUANT_SEEDS = 64            # launches of the unbiasedness check
# Dense weights of the two towers: conv1, proj and 12 x 4 in the vision tower,
# the projection and 12 x 4 in the text tower
QUANT_LAUNCHES = {"vision": 50, "text": 49}
INT8_COSINE_MIN = 0.99      # int8 encoders vs the bf16 model, every row (the JAX tests' bar)
# maxsim(impl='streaming_int8') vs the default forward on unit-norm tokens:
# per-token symmetric int8 carries about 1e-2 absolute error a similarity
INT8_MAXSIM_TOL = 2e-2
INT8_STEP_LOSS_TOL = 5e-2   # a colclip step with the int8 forward vs the default step
TOWER_LAYERS = 12           # blocks in each tower: one attention launch each an encode
INDEX_ITEMS = 2048
INDEX_BATCH = 256
SEARCH_K, SEARCH_SHORTLIST = 10, 100
# phase 10 (and phase 7's epoch-end eval): the vendored Flickr30k val
# annotations (1,014 images, 5,070 captions), a seeded JPEG at each image path
# phase 11: seeded tar shards in the reference's recaption layout, trained by
# main in three feeds at batch TRAIN_BATCH; 8 shards of 384 samples give 12
# batches, rounded to 8 an epoch for 8 workers, so each epoch is cut at
# TAR_STEPS_PER_EPOCH
TAR_MODEL = "ViT-B-16-colxlip"
TAR_SHARDS = 8
TAR_PER_SHARD = 384
TAR_STEPS_PER_EPOCH = 6
TAR_HOST_BATCHES = 6
YUV_TOL = 2e-4            # the JAX bar (tests/test_yuv420.py)
NATIVE_RMS_MAX = 12.0     # pixel units, the JAX bar (tests/test_native.py)
# phase 12: the data-parallel step under a process group of one
DIST_BACKEND = "nccl"
DIST_STEPS = 4              # the first compared, the rest timed (learning rate 0)
DIST_LOSS_TOL = 1e-5        # the losses; the gradients take STEP_TOL of their dtype
DIST_MAXSIM_SHAPES = [(256, 1024), (1024, 256)]   # local-loss rows at 4 ranks x 256
DIST_CE_SHAPE = (256, 1024, 768)                  # M, N, rank 3's label offset
# phase 14: one device's share of the pod recipes (scripts/train_merged30m_v5e64.sh,
# scripts/train_vitl14_v5e64.sh: --local-loss --token-dist ring --token-neighborhood 8
# --gather-with-grad), through parallel/pod_shape.py
POD_MODEL = "ViT-B-16-colxlip"
POD_BATCH = 256
POD_DEVICES = 64            # M: the pooled banks hold M x b rows
POD_K = 8                   # the ring window
POD_ALPHA = 0.7
POD_TEXT_CTX = 64           # the recipes' --text-ctx
POD_STEPS = 4               # at learning rate 0; the step time is the median of steps 2-4
POD_VIT_L_BATCH = 64        # the ViT-L-14 recipe's batch
POD_COMPARE = (8, 4)        # M, K of the batch-64 step held against the plain versions
POD_LOSS_TOL = 1e-5         # 'scan' against 'fused' in fp32
POD_MAXSIM_SHAPES = [(256, 2048), (2048, 256)]   # the fused window at b 256, K 8
# phase 15: --async-checkpoint and --precision pure_bf16 through main
SAVE_EPOCHS = 3
SAVE_STEPS_PER_EPOCH = 2
# phase 16: sharded state under a process group of one
GSPMD_STEPS = 4             # the first compared, the rest timed (learning rate 0)
# phase 17: the serving bundle's batches (a symbolic batch dim)
AOT_BATCHES = (1, 8, 64)
REPO = os.path.dirname(os.path.abspath(__file__))
FLICKR_ANNOTATIONS = os.path.join(REPO, "datasets", "flickr30k-images", "flickr30k_val.json")
EVAL_MODEL = "ViT-B-16-colxlip"
EVAL_BATCH = 256            # --batch-size: texts and images an encode batch
EVAL_ALPHA = 0.5
EVAL_IMAGE_SIDES = (256, 500)
ZS_CLASSES = 1000           # one seeded image a class, the vendored class names
# zero-shot logits, kernels vs plain versions: cosines of unit-norm image
# features and class weights, so |f'.c' - f.c| <= |f' - f| + |c' - c|, and a
# 1 - cosine of ENCODE_COSINE_TOL on each allows sqrt(2 ENCODE_COSINE_TOL)
ZS_LOGIT_TOL = 2 * (2 * ENCODE_COSINE_TOL) ** 0.5
ZS_BATCH_CLASSES = 32       # zero_shot.build_zero_shot_classifier's batch of classes
# phase 13: the other loss families through main, and CoCa captioning
FAMILY_BATCH = 256
FAMILY_STEPS = 6            # epochs of one step on one seeded batch
SIGLIP_MODEL = "ViT-B-16"
DISTILL_STUDENT, DISTILL_TEACHER = "ViT-B-32", "ViT-B-16"
COCA_MODEL = "coca_ViT-B-32"
COCA_LAYERS = 12            # self-attention blocks of the vision tower, and of the decoder
CAPTION_IMAGES = 8
# the dense caption CE rounds the logits to bf16 before its fp32 logsumexp;
# the streamed one sums the products in fp32: a relative difference of a
# few 1e-3 on a loss near ln 49408
CAPTION_FUSED_TOL = 1e-2


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def jpeg_b64(rng, h: int, w: int) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype="uint8")).save(
        buf, format="JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def http(port: int, path: str, body=None):
    """(response JSON, seconds) for a GET (body None) or a JSON POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors through the kernels' plain versions, forward and
    backward (for the plain-path recomputations only)."""
    from colxlip_tpu_torch.ops import attention, fused_ln, fused_mlp, maxsim

    mods = (attention, maxsim, fused_ln, fused_mlp)
    saved = [(mod, name, getattr(mod, name)) for mod in mods
             for name in ("_launch_fwd", "_launch_bwd")]
    attention._launch_fwd = attention.fused_mha_plain
    attention._launch_bwd = attention.fused_mha_bwd_plain
    maxsim._launch_fwd = lambda t, i, mode, mask: maxsim.maxsim_plain(
        t, i, mask_mode=mode, text_mask=mask)
    maxsim._launch_bwd = lambda t, i, g, mode, mask: maxsim.maxsim_bwd_plain(
        t, i, g, mask_mode=mode, text_mask=mask)
    fused_ln._launch_fwd = fused_ln.layernorm_plain
    fused_ln._launch_bwd = fused_ln.layernorm_bwd_plain
    fused_mlp._launch_fwd = fused_mlp.fused_mlp_plain
    fused_mlp._launch_bwd = fused_mlp.fused_mlp_bwd_plain
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def fused_towers(names=("COLXLIP_LN_IMPL", "COLXLIP_MLP_IMPL"), value: str = "fused"):
    """COLXLIP_LN_IMPL=fused and COLXLIP_MLP_IMPL=fused (or the variables
    named, set to ``value``) while models are built (the modules read them
    once, in their constructors)."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: value for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fused_counters():
    """The launch counters of the LayerNorm and MLP kernels, by kernel name."""
    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    return {"fused_ln_fwd": fused_ln.FWD_LAUNCHES, "fused_ln_bwd": fused_ln.BWD_LAUNCHES,
            "fused_mlp_fwd": fused_mlp.FWD_LAUNCHES, "fused_mlp_bwd": fused_mlp.BWD_LAUNCHES}


def check_default_path(counters, phase: str) -> None:
    """The default path (neither variable set) launches none of them."""
    got = {name: c.value for name, c in counters.items()}
    if any(got.values()):
        raise RuntimeError(f"{phase}: the default path launched LayerNorm / MLP kernels: {got}")


def max_rel_err(got, want, floor: float = 1e-30) -> float:
    """max |got - want| over max(floor, largest |want|), both read as fp32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(floor)).item()


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    """(least ms the card could take, 'bytes' or 'operations'): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate for the input type."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attention_bounds(qkv_fwd, qkv_bwd, causal: bool = False):
    """bound_ms of the two attention kernels on packed QKV [B, N, 3 H D]: the
    forward reads qkv and writes out (4 B N H D elements) for 4 B H N^2 D
    flops; the backward also reads dout and writes dqkv (7) for 10 (the five
    products the function needs). Under the causal mask a query meets only
    the keys up to itself: N (N + 1) / 2 pairs instead of N^2."""
    out = {}
    for key, qkv, passes, flop_factor in (("fused_attention_fwd", qkv_fwd, 4, 4),
                                          ("fused_attention_bwd", qkv_bwd, 7, 10)):
        b, n, width = qkv.shape
        hd = width // 3
        pairs = n * (n + 1) / 2 if causal else n * n
        out[key] = bound_ms(b * n * hd * passes * qkv.element_size(),
                            flop_factor * b * pairs * hd, str(qkv.dtype).split(".")[-1])
    return out


def maxsim_bound(text, image, backward: bool):
    """bound_ms of a MaxSim kernel on text [M, Lt, D] and image [K, Li, D]:
    the similarities are 2 M K Lt Li D flops, the backward adds dT and dI at
    2 M K Lt D each; the features are read once (and their gradients written
    once, backward) and the [M, K] scores (or their cotangent) move once."""
    (m, lt, d), (k, li, _) = text.shape, image.shape
    feats = (m * lt + k * li) * d * text.element_size()
    flops = 2 * m * k * lt * li * d + (4 * m * k * lt * d if backward else 0)
    return bound_ms(feats * (2 if backward else 1) + m * k * 4, flops,
                    str(text.dtype).split(".")[-1])


def mlp_bounds(x, w1):
    """bound_ms of the two MLP kernels on x [B, N, D], w1 [H, D]: 4 R D H
    flops forward (two products) over 2 R D + 2 D H elements, 10 R D H
    backward (five products) over 3 R D + 6 D H."""
    (h, d), r = w1.shape, x.numel() // x.shape[-1]
    size, dtype = x.element_size(), str(x.dtype).split(".")[-1]
    return {"fused_mlp_fwd": bound_ms((2 * r * d + 2 * d * h) * size, 4 * r * d * h, dtype),
            "fused_mlp_bwd": bound_ms((3 * r * d + 6 * d * h) * size, 10 * r * d * h, dtype)}


def ce_bounds(a, b):
    """bound_ms of the three CE kernels on a [M, D], b [N, D]: 2 M N D flops
    forward, 4 M N D in dA and in dB; the features read once, the per-row
    values (and dA or dB) written once."""
    (m, d), n = a.shape, b.shape[0]
    feats, dtype = (m + n) * d * a.element_size(), str(a.dtype).split(".")[-1]
    return {"fused_ce_fwd": bound_ms(feats + 3 * m * 4, 2 * m * n * d, dtype),
            "fused_ce_bwd_da": bound_ms(feats + 4 * m * 4 + m * d * 4, 4 * m * n * d, dtype),
            "fused_ce_bwd_db": bound_ms(feats + 3 * m * 4 + n * d * 4, 4 * m * n * d, dtype)}


def kernel_bounds(qkv_fwd, qkv_bwd, heads, maxsim_fwd, maxsim_bwd, ce, ln_x, mlp_x, mlp_w1):
    """bound_ms of every kernel at the shape its ``ms`` is timed at, from the
    tensors themselves: attention (packed QKV [B, N, 3 H D]; 4 B H N^2 D
    flops forward, 10 backward: five products), MaxSim (text [M, Lt, D],
    image [K, Li, D]; the similarities are 2 M K Lt Li D flops, the backward
    adds dT and dI at 2 M K Lt D each), CE (a [M, D], b [N, D]; 2 M N D
    forward, 4 M N D in dA and in dB), LayerNorm (x [R, D]: 2 R D elements
    forward and 3 R D backward, 8 and 16 operations an element, the counts
    the TPU kernels declare), MLP (x [B, N, D], w1 [H, D]: 4 B N D H flops
    forward, two products; 10 backward, the five products the function
    needs: h recomputed from x, dW2, da, dW1 and dx, where the TPU kernel's
    declared 12 counts one too many; over 2 B N D + 2 D H and
    3 B N D + 6 D H elements)."""
    def name(t):
        return str(t.dtype).split(".")[-1]

    out = attention_bounds(qkv_fwd, qkv_bwd)
    out["maxsim_fwd"] = maxsim_bound(*maxsim_fwd, False)
    out["maxsim_bwd"] = maxsim_bound(*maxsim_bwd, True)
    out.update(ce_bounds(*ce))
    r, d = ln_x.numel() // ln_x.shape[-1], ln_x.shape[-1]
    out["fused_ln_fwd"] = bound_ms(2 * r * d * ln_x.element_size(), 8 * r * d, name(ln_x))
    out["fused_ln_bwd"] = bound_ms(3 * r * d * ln_x.element_size(), 16 * r * d, name(ln_x))
    out.update(mlp_bounds(mlp_x, mlp_w1))
    return out


def ce_inputs(m, n, d, scale, dtype, dev, gen):
    import torch

    a, b = (torch.nn.functional.normalize(torch.randn(rows, d, generator=gen), dim=-1)
            .to(dev, dtype) for rows in (m, n))
    labels = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32).to(dev)
    g = (torch.rand(m, generator=gen) / m).to(dev)
    return a, b, labels, torch.tensor(scale, device=dev), g


def check_ce_kernels(dev, gen):
    """Phase 3c: the three streaming-CE kernels against their plain versions.
    Returns (max errors per kernel, bf16 inputs by M for the timings)."""
    import torch

    from colxlip_tpu_torch.ops import fused_ce

    def unit_err(got, want):
        return ((got - want).abs() / (1 + want.abs())).max().item()

    errs = {"fused_ce_fwd": 0.0, "fused_ce_bwd_da": 0.0, "fused_ce_bwd_db": 0.0}
    inputs = {}
    for m, n, d, scale, dtypes, tied, seed in CE_CASES:
        case_gen = gen if seed is None else torch.Generator().manual_seed(seed)
        for name in dtypes:
            a, b, labels, s, g = ce_inputs(m, n, d, scale, getattr(torch, name), dev, case_gen)
            if tied:
                b = a.clone()
            loss, lse = fused_ce._launch_fwd(a, b, labels, s)
            da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
            db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
            again = (*fused_ce._launch_bwd_da(a, b, labels, s, lse, g),
                     fused_ce._launch_bwd_db(a, b, labels, s, lse, g))
            want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
            # the plain backward starts from the plain lse: only the kernels differ
            want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
            want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
            torch.cuda.synchronize()
            err = {"fused_ce_fwd": max(unit_err(loss, want_loss), unit_err(lse, want_lse)),
                   "fused_ce_bwd_da": max(max_rel_err(da, want_da), max_rel_err(ds, want_ds)),
                   "fused_ce_bwd_db": max_rel_err(db, want_db)}
            log(f"[3 kernels] fused CE M={m} N={n} D={d} scale={scale:.4g}"
                f"{' b=a' if tied else ''} {name}: fwd "
                f"|err| / (1 + |loss|) {err['fused_ce_fwd']:.3g} (tol {CE_FWD_TOL}); "
                f"max_abs_err / max|grad| dA+dscale {err['fused_ce_bwd_da']:.3g}, dB "
                f"{err['fused_ce_bwd_db']:.3g} (tol {CE_BWD_TOL}); loss mean "
                f"{loss.mean().item():.5f}")
            if not (err["fused_ce_fwd"] <= CE_FWD_TOL and torch.isfinite(loss).all()
                    and err["fused_ce_bwd_da"] <= CE_BWD_TOL
                    and err["fused_ce_bwd_db"] <= CE_BWD_TOL):
                raise RuntimeError(f"fused CE M={m} N={n} {name}: {err}")
            if not all(torch.equal(x, y) for x, y in zip((da, ds, db), again)):
                raise RuntimeError(f"fused CE M={m} N={n} {name}: two runs of the backward "
                                   "kernels differ (they use no atomics)")
            errs = {k: max(v, err[k]) for k, v in errs.items()}
            if name == "bfloat16" and d == 512 and not tied and m == n:
                inputs[m] = (a, b, labels, s, lse, g)
            del loss, da, ds, db, again, want_loss, want_lse, want_da, want_ds, want_db

    # no [M, N] tensor on the kernel path: forward and backward under autograd
    a, b, labels, s, _, _ = inputs[32768]
    a_, b_, s_ = a.clone().requires_grad_(), b.clone().requires_grad_(), \
        s.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fused_ce.fused_contrastive_ce(a_, b_, labels, s_).backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    dense = a.shape[0] * b.shape[0] * 4 / 2**30
    log(f"[3 kernels] fused CE M=N=32768 bf16 forward + backward under autograd: peak device "
        f"memory {peak:.3f} GiB above the inputs (limit {CE_PEAK_LIMIT_GIB}; dense fp32 "
        f"logits alone would be {dense:.0f} GiB); two backward runs bit-equal at every shape")
    if not (peak <= CE_PEAK_LIMIT_GIB and torch.isfinite(a_.grad).all()
            and torch.isfinite(b_.grad).all() and torch.isfinite(s_.grad)):
        raise RuntimeError(f"fused CE at 32768: peak {peak} GiB or non-finite gradients")
    return errs, inputs


def time_ce_kernels(inputs, card: str):
    """Phase 5: each CE kernel, its plain version and the dense pair
    (fp32 torch.matmul + F.cross_entropy, forward and forward + backward)."""
    import torch
    import torch.nn.functional as F

    from colxlip_tpu_torch.ops import fused_ce

    timing = {}
    for m, (a, b, labels, s, lse, g) in inputs.items():
        iters, warm = (50, 3) if m <= 256 else (10, 2) if m <= 4096 else (2, 1)
        row = {
            "fwd": (cuda_ms(lambda: fused_ce._launch_fwd(a, b, labels, s), iters, warm),
                    cuda_ms(lambda: fused_ce.fused_ce_fwd_plain(a, b, labels, s), iters, warm)),
            "bwd_da": (
                cuda_ms(lambda: fused_ce._launch_bwd_da(a, b, labels, s, lse, g), iters, warm),
                cuda_ms(lambda: fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g),
                        iters, warm)),
            "bwd_db": (
                cuda_ms(lambda: fused_ce._launch_bwd_db(a, b, labels, s, lse, g), iters, warm),
                cuda_ms(lambda: fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g),
                        iters, warm)),
        }
        long_labels = labels.long()
        a_, b_, s_ = a.clone().requires_grad_(), b.clone().requires_grad_(), \
            s.clone().requires_grad_()

        def dense():
            return F.cross_entropy(s_ * torch.matmul(a_.float(), b_.float().T), long_labels)

        def dense_fwd():
            with torch.no_grad():
                dense()

        dense_ms = (cuda_ms(dense_fwd, iters, warm),
                    cuda_ms(lambda: torch.autograd.grad(dense(), (a_, b_, s_)), iters, warm))
        bounds = ce_bounds(a, b)
        for key, (ker, plain) in row.items():
            timing[f"fused_ce_{key}/{m}"] = (ker, plain)
            bound, by = bounds[f"fused_ce_{key}"]
            log(f"[5 timing] fused_ce_{key} M=N={m} D={a.shape[1]} bf16: kernel {ker:.4f} ms, "
                f"plain {plain:.4f} ms, bound {bound:.5f} ms ({by}) ({card})")
        log(f"[5 timing] dense pair M=N={m} (fp32 torch.matmul + F.cross_entropy, holds "
            f"[M, N]): forward {dense_ms[0]:.4f} ms, forward + backward {dense_ms[1]:.4f} ms; "
            f"the three kernels together {sum(k for k, _ in row.values()):.4f} ms ({card})")
        timing[f"dense_ce/{m}"] = dense_ms
        timing[f"ce_bounds/{m}"] = bounds
        del a_, b_, s_
        torch.cuda.empty_cache()
    return timing


def mlp_inputs(b, n, d, h, dtype, dev, gen):
    """x, w1 [H, D], b1, w2 [H, D], b2, dy at the scales of a tower at init:
    unit-variance rows (a LayerNorm's output), lecun-normal weights."""
    import torch

    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def t(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    return (t((b, n, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1), t((b, n, d), 1.0))


def hold_mlp_forward(label, args, approximate, out, controls=False):
    """The bf16 MLP forward ``out`` of ``args`` (x, w1, b1, w2, b2) against its
    per-element bar (ops/fused_mlp_check.py); raises if any element is
    outside. With ``controls`` both controls must fail the same bar: the
    forward with its K sums kept in bf16 (on the first MLP_CONTROL_ROWS
    rows) and ``out`` with one element moved three bf16 steps."""
    import torch

    from colxlip_tpu_torch.ops import fused_mlp_check as check

    bar = check.forward_bar(*args, approximate)
    report = check.check_forward(out, bar)
    log(f"[3 kernels] {label} bf16 forward: {check.describe(report)}")
    if not report["ok"]:
        raise RuntimeError(f"{label} bf16 forward: {report['outside']} elements outside the "
                           "per-element bar")
    if not controls:
        return report
    d = out.shape[-1]
    rows = min(MLP_CONTROL_ROWS, out.numel() // d)
    x = args[0].reshape(-1, d)[:rows]
    part = check.Bar(*(t.reshape(-1, d)[:rows] for t in bar))
    for name, got, want_bar in (
            (f"K sums kept in bf16 ({rows} rows)",
             check.bf16_sum_forward(x, *args[1:], approximate), part),
            ("one element moved three steps", check.moved_three_steps(out, bar), bar)):
        control = check.check_forward(got, want_bar)
        log(f"[3 kernels] {label} control, {name}: {check.describe(control)}")
        if control["ok"]:
            raise RuntimeError(f"{label}: the control '{name}' passes the bar")
    torch.cuda.synchronize()
    return report


def check_fused_kernels(dev, gen):
    """Phase 3d: the LayerNorm and MLP kernels against their plain versions.
    Returns (max errors per kernel, bf16 inputs by case name for the timings)."""
    import torch

    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    errs = {"fused_ln_fwd": 0.0, "fused_ln_bwd": 0.0, "fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    inputs = {}

    def hold(kind, label, name, fwd_err, bwd_err, got, again, fwd_tol=None):
        f_tol = FUSED_FWD_TOL[name] if fwd_tol is None else fwd_tol
        b_tol = FUSED_BWD_TOL[name]
        held = f"tol {f_tol:.3g}" if math.isfinite(f_tol) else "printed, not held"
        log(f"[3 kernels] {label} {name}: forward max_abs_err / max(1, max|out|) "
            f"{fwd_err:.3g} ({held}); backward max_abs_err / max|grad| "
            f"{bwd_err:.3g} (tol {b_tol:.3g})")
        if not (fwd_err <= f_tol and bwd_err <= b_tol):
            raise RuntimeError(f"{label} {name}: forward {fwd_err} > {f_tol} or backward "
                               f"{bwd_err} > {b_tol}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"{label} {name}: two runs of the backward kernel differ "
                               "(it uses no atomics)")
        errs[f"{kind}_fwd"] = max(errs[f"{kind}_fwd"], fwd_err)
        errs[f"{kind}_bwd"] = max(errs[f"{kind}_bwd"], bwd_err)

    for case, lead, d, seed in LN_CASES:
        case_gen = gen if seed is None else torch.Generator().manual_seed(seed)
        x32 = torch.randn(*lead, d, generator=case_gen) * 2 + 0.5
        dy32 = torch.randn(*lead, d, generator=case_gen)
        scale = (1 + 0.1 * torch.randn(d, generator=case_gen)).to(dev)
        bias = (0.1 * torch.randn(d, generator=case_gen)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, dy = x32.to(dev, dtype), dy32.to(dev, dtype)
            y = fused_ln._launch_fwd(x, scale, bias, 1e-5)
            got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            want_y = fused_ln.layernorm_plain(x, scale, bias, 1e-5)
            want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
            torch.cuda.synchronize()
            hold("fused_ln", f"layernorm {case} {tuple(x.shape)}", name,
                 max_rel_err(y, want_y, 1.0), max(max_rel_err(g, w) for g, w in zip(got, want)),
                 got, again)
            if dtype == torch.bfloat16:
                inputs[f"ln/{case}"] = (x, scale, bias, dy)
            del y, got, again, want_y, want

    for case, b, n, d, h, branches, dtypes in MLP_CASES:
        for name in dtypes:
            dtype = getattr(torch, name)
            x, w1, b1, w2, b2, dy = mlp_inputs(b, n, d, h, dtype, dev, gen)
            for approximate in branches:
                out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, approximate)
                got = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
                again = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
                want_out = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate)
                want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
                torch.cuda.synchronize()
                label = (f"mlp {case} B={b} N={n} D={d} H={h} "
                         f"gelu={'tanh' if approximate else 'erf polynomial'}")
                if dtype == torch.bfloat16:
                    hold_mlp_forward(label, (x, w1, b1, w2, b2), approximate, out,
                                     controls=case == "vision")
                # bf16: the forward's aggregate against the plain version is printed,
                # not held (the per-element bar above holds it)
                hold("fused_mlp", label, name, max_rel_err(out, want_out, 1.0),
                     max(max_rel_err(g, w) for g, w in zip(got, want)), got, again,
                     math.inf if dtype == torch.bfloat16 else None)
                del out, got, again, want_out, want
            if dtype == torch.bfloat16:
                inputs[f"mlp/{case}"] = (x, w1, b1, w2, b2, dy)

    case, b, n, d, h, seed = MLP_FP32_WIDE
    args = mlp_inputs(b, n, d, h, "float32", dev, torch.Generator().manual_seed(seed))
    x, w1, b1, w2, b2, dy = args
    out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, False)
    got = fused_mlp._launch_bwd(x, w1, b1, w2, dy, False)
    again = fused_mlp._launch_bwd(x, w1, b1, w2, dy, False)
    want_out = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False)
    want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False)
    torch.cuda.synchronize()
    hold("fused_mlp", f"mlp {case} B={b} N={n} D={d} H={h} gelu=erf polynomial "
         f"({fused_mlp.fp32_feature_slices(d)} feature slices)", "float32",
         max_rel_err(out, want_out, 1.0), max(max_rel_err(g, w) for g, w in zip(got, want)),
         got, again)
    inputs[f"mlp32/{case}"] = args
    del out, got, again, want_out, want

    # no [B, N, H] tensor on the kernel path, either direction, under autograd
    x, w1, b1, w2, b2, dy = inputs["mlp/vision"]
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    hidden = x.numel() // x.shape[-1] * w1.shape[0] * x.element_size() / 2**20
    peaks = []
    out = None
    for direction in ("forward", "backward"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        if direction == "forward":
            out = fused_mlp.fused_mlp(*leaves)
        else:
            out.backward(dy)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated(dev) - base) / 2**20)
    log(f"[3 kernels] mlp vision bf16 under autograd: peak device memory above what was held "
        f"before, forward {peaks[0]:.1f} MiB, backward {peaks[1]:.1f} MiB; one [B, N, H] "
        f"tensor would be {hidden:.1f} MiB; two backward runs bit-equal at every shape")
    if not (max(peaks) < hidden and all(torch.isfinite(t.grad).all() for t in leaves)):
        raise RuntimeError(f"fused MLP: peaks {peaks} MiB reach one hidden tensor ({hidden} "
                           "MiB), or a gradient is not finite")
    return errs, inputs


def time_fused_kernels(inputs, card: str):
    """Phase 5: the LayerNorm and MLP kernels, their plain versions, and the
    library beside them (F.layer_norm forward and backward; F.linear, F.gelu,
    F.linear and their autograd backward), bf16 at the training shapes, and
    the MLP in fp32 at MLP_FP32_WIDE."""
    import torch
    import torch.nn.functional as F

    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    timing, ln_bwd = {}, {}
    for case in ("vision", "text", "token-head", "vit-l"):
        x, scale, bias, dy = inputs[f"ln/{case}"]
        d = x.shape[-1]
        w, b = scale.to(x.dtype), bias.to(x.dtype)
        x_ = x.clone().requires_grad_()
        w_, b_ = w.clone().requires_grad_(), b.clone().requires_grad_()
        y_ = F.layer_norm(x_, (d,), w_, b_, 1e-5)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-5), 20)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(y_, (x_, w_, b_), dy, retain_graph=True), 20)
        timing[f"fused_ln_fwd/{case}"] = (
            cuda_ms(lambda: fused_ln._launch_fwd(x, scale, bias, 1e-5), 20),
            cuda_ms(lambda: fused_ln.layernorm_plain(x, scale, bias, 1e-5), 20), lib_fwd)
        timing[f"fused_ln_bwd/{case}"] = (
            cuda_ms(lambda: fused_ln._launch_bwd(x, scale, dy, 1e-5), 20),
            cuda_ms(lambda: fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5), 20), lib_bwd)
        # #8's two kernels apart, and the same bytes moved with no arithmetic
        sink = torch.empty_like(x)
        split = device_ms_by_kernel(lambda: fused_ln._launch_bwd(x, scale, dy, 1e-5), 10,
                                    r"(ln_bwd_kernel|reduce_partials)")
        rows = x.numel() // d
        ln_bwd[case] = {
            "ms": timing[f"fused_ln_bwd/{case}"][0], "plain_ms": timing[f"fused_ln_bwd/{case}"][1],
            "library_ms": lib_bwd,
            "bound_ms": bound_ms(3 * rows * d * x.element_size(), 16 * rows * d, "bfloat16")[0],
            "row_kernel_ms": split.get("ln_bwd_kernel"), "reduce_ms": split.get("reduce_partials"),
            "same_bytes_add_ms": cuda_ms(lambda: torch.add(x, dy, out=sink), 20)}
        del x_, w_, b_, y_, sink
    for case, *_ in MLP_CASES:
        x, w1, b1, w2, b2, dy = inputs[f"mlp/{case}"]
        lib_fwd, lib_bwd = three_call_mlp_ms(x, w1, b1, w2, b2, dy, 5, 2)
        timing[f"fused_mlp_fwd/{case}"] = (
            cuda_ms(lambda: fused_mlp._launch_fwd(x, w1, b1, w2, b2, False), 10, 2),
            cuda_ms(lambda: fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False), 3, 1), lib_fwd)
        timing[f"fused_mlp_bwd/{case}"] = (
            cuda_ms(lambda: fused_mlp._launch_bwd(x, w1, b1, w2, dy, False), 10, 2),
            cuda_ms(lambda: fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False), 3, 1),
            lib_bwd)
        bounds = mlp_bounds(x, w1)
        for key in ("fused_mlp_fwd", "fused_mlp_bwd"):
            ker = timing[f"{key}/{case}"][0]
            log(f"[5 timing] {key}/{case} B={x.shape[0]} N={x.shape[1]} D={x.shape[2]} "
                f"H={w1.shape[0]} bf16: kernel {ker:.4f} ms against its bound "
                f"{bounds[key][0]:.5f} ms ({bounds[key][1]}) = {bounds[key][0] / ker:.1%} of "
                f"it ({card})")
    timing.update(time_mlp_fp32_wide(inputs, card))
    for key, (ker, plain, lib) in timing.items():
        what = ("F.layer_norm" if key.startswith("fused_ln") else
                "F.linear, F.gelu, F.linear" + (" (autograd backward: forward + backward less "
                                                "forward)" if "bwd" in key else ""))
        log(f"[5 timing] {key} {'fp32' if 'fp32' in key else 'bf16'}: kernel {ker:.4f} ms, "
            f"plain {plain:.4f} ms, {what} {lib:.4f} ms ({card})")
    def device(ms):
        return "not measured (the profiler recorded no event)" if ms is None else f"{ms:.4f} ms"

    for case, row in ln_bwd.items():
        log(f"[5 timing] fused_ln_bwd/{case}: row kernel {device(row['row_kernel_ms'])} + "
            f"partial-row reduce {device(row['reduce_ms'])} of device time (torch.profiler); the "
            f"call {row['ms']:.4f} ms against its bound {row['bound_ms']:.5f} ms = "
            f"{row['bound_ms'] / row['ms']:.1%} of it; torch.add(x, dy) (the same bytes) "
            f"{row['same_bytes_add_ms']:.4f} ms ({card})")
    timing["ln_bwd_cases"] = ln_bwd
    torch.cuda.empty_cache()
    return timing


def three_call_mlp_ms(x, w1, b1, w2, b2, dy, iters: int, warmup: int):
    """(forward ms, backward ms) of F.linear, F.gelu, F.linear on the MLP
    kernels' inputs (w2 [H, D] transposed to F.linear's [D, H]); the
    backward is the autograd forward + backward less the forward."""
    import torch
    import torch.nn.functional as F

    w2_out_in = w2.t().contiguous()
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2_out_in, b2)]

    def three_calls(x, w1, b1, w2, b2):
        return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)

    with torch.no_grad():
        fwd = cuda_ms(lambda: three_calls(x, w1, b1, w2_out_in, b2), iters, warmup)
    both = cuda_ms(lambda: torch.autograd.grad(three_calls(*leaves), leaves, dy), iters, warmup)
    return fwd, both - fwd


def time_mlp_fp32_wide(inputs, card: str) -> dict:
    """Phase 5: kernels #9 and #10 in fp32 at MLP_FP32_WIDE (the feature
    slices past D = 768), their plain versions, the three library calls in
    fp32 (TF32 off) and the bound."""
    from colxlip_tpu_torch.ops import fused_mlp

    case = MLP_FP32_WIDE[0]
    x, w1, b1, w2, b2, dy = inputs[f"mlp32/{case}"]
    lib = three_call_mlp_ms(x, w1, b1, w2, b2, dy, 3, 1)
    out = {f"fused_mlp_fwd/{case}-fp32": (
        cuda_ms(lambda: fused_mlp._launch_fwd(x, w1, b1, w2, b2, False), 3, 1),
        cuda_ms(lambda: fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False), 3, 1), lib[0]),
        f"fused_mlp_bwd/{case}-fp32": (
        cuda_ms(lambda: fused_mlp._launch_bwd(x, w1, b1, w2, dy, False), 3, 1),
        cuda_ms(lambda: fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False), 3, 1), lib[1])}
    bounds = mlp_bounds(x, w1)
    for key in ("fused_mlp_fwd", "fused_mlp_bwd"):
        ker = out[f"{key}/{case}-fp32"][0]
        log(f"[5 timing] {key}/{case}-fp32 R={x.numel() // x.shape[-1]} D={x.shape[-1]} "
            f"H={w1.shape[0]} fp32 ({fused_mlp.fp32_feature_slices(x.shape[-1])} feature "
            f"slices): kernel {ker:.4f} ms against its bound {bounds[key][0]:.5f} ms "
            f"({bounds[key][1]}) = {bounds[key][0] / ker:.1%} of it ({card})")
    return out


def profiled(fn):
    """torch.profiler (CPU and CUDA) over one run of ``fn`` that follows one
    warm-up run under the same profiler: the tracer can drop the device
    events of its first moments (seen on the card: 19 of 20 launches, or none
    of a kernel's, recorded), so the recorded window opens only once tracing
    runs. Returns (the recorded events of ``key_averages()`` without the
    schedule's own ``ProfilerStep#`` span, which the device timeline carries
    too; the recorded run's wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    return [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")], wall_ms


def device_ms_by_kernel(fn, calls: int, pattern: str) -> dict:
    """Device ms a call of each kernel whose name matches ``pattern`` (its
    first group names it) over ``calls`` calls of ``fn`` (torch.profiler)."""
    import torch

    events, _ = profiled(lambda: [fn() for _ in range(calls)])
    out = {}
    for e in events:
        found = re.search(pattern, e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            out[found.group(1)] = out.get(found.group(1), 0.0) + \
                e.self_device_time_total / 1e3 / calls
    return out


def time_library_attention(qkv, dout, heads: int, causal: bool):
    """(forward ms, backward ms) of F.scaled_dot_product_attention on the
    same packed QKV (timed only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    b, n, width = qkv.shape
    d = width // (3 * heads)
    q, k, v = (t.contiguous().requires_grad_()
               for t in qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 10)
    if dout is None:
        return fwd, None
    grad = dout.view(b, n, heads, d).permute(0, 2, 1, 3).contiguous()
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True), 10)
    return fwd, bwd


def check_backward_kernels(dev, gen):
    """Phase 3b: each backward kernel against its plain version at the
    training shapes, in fp32 and bf16. Returns (max errors, timing inputs)."""
    import torch

    from colxlip_tpu_torch.ops import attention, maxsim

    errs = {"attention_bwd": 0.0, "maxsim_bwd": 0.0}
    inputs = {}
    both = ("float32", "bfloat16")
    for name, b, n, h, d, causal, dtypes in (("vision", TRAIN_BATCH, 197, 12, 64, False, both),
                                             ("text", TRAIN_BATCH, 77, 8, 64, True, both),
                                             ("tiny-d32", 8, 32, 4, 32, True, both),
                                             *ATTN_EXTRA_CASES):
        qkv = torch.randn(b, n, 3 * h * d, generator=gen)
        dout = torch.randn(b, n, h * d, generator=gen)
        for dtype in (getattr(torch, t) for t in dtypes):
            q, g = qkv.to(dev, dtype), dout.to(dev, dtype)
            got = attention._launch_bwd(q, g, h, causal)
            want = attention.fused_mha_bwd_plain(q, g, h, causal)
            torch.cuda.synchronize()
            err, tol = max_rel_err(got, want), BWD_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] attention bwd {name} B={b} N={n} H={h} D={d} "
                f"causal={causal} {dtype}: max_abs_err / max|grad| {err:.3g} (tol {tol})")
            if not err <= tol:
                raise RuntimeError(f"attention bwd {name} {dtype}: {err} > {tol}")
            errs["attention_bwd"] = max(errs["attention_bwd"], err)
            if dtype == torch.bfloat16 and name in ("vision", "text", "tiny-d32"):
                inputs[f"attention_bwd/{name}"] = (q, g, h, causal)
            if dtype == torch.bfloat16 and name == "vision":
                # no atomics in either pass: a second run gives the same bits
                same = torch.equal(got, attention._launch_bwd(q, g, h, causal))
                log(f"[3 kernels] attention bwd {name} {dtype}: two runs "
                    f"{'equal bit for bit' if same else 'DIFFER'}")
                if not same:
                    raise RuntimeError("two runs of the attention backward differ")
            del got, want

    m = k = TRAIN_BATCH
    lt, li, d = 77, 196, 512
    t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
    eot = torch.randint(3, lt, (m,), generator=gen)
    keep = torch.arange(lt)[None, :] < eot[:, None]
    t = t * keep[:, :, None]                                # zero rows past EOT
    img = torch.nn.functional.normalize(torch.randn(k, li, d, generator=gen), dim=-1)
    gs = torch.randn(m, k, generator=gen) / m
    text_mask = keep.float().to(dev)
    errs["maxsim_fwd"] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tt, ii, g = t.to(dev, dtype), img.to(dev, dtype), gs.to(dev)
        modes = ("nonzero", "plain", "valid") if dtype == torch.bfloat16 else ("nonzero",)
        for mode in modes:
            errs["maxsim_fwd"] = max(errs["maxsim_fwd"],
                                     check_maxsim_forward(tt, ii, mode, text_mask, "main path"))
            got = maxsim._launch_bwd(tt, ii, g, mode, text_mask)
            want = maxsim.maxsim_bwd_plain(tt, ii, g, mask_mode=mode, text_mask=text_mask)
            torch.cuda.synchronize()
            err = max(max_rel_err(a, w) for a, w in zip(got, want))
            tol = BWD_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] maxsim bwd {mode} M={m} K={k} Lt={lt} Li={li} D={d} {dtype}: "
                f"max_abs_err / max|grad| {err:.3g} (tol {tol}) (dT, dI)")
            if not err <= tol:
                raise RuntimeError(f"maxsim bwd {mode} {dtype}: {err} > {tol}")
            errs["maxsim_bwd"] = max(errs["maxsim_bwd"], err)
            if mode == "nonzero":
                # dI adds in one fixed order, no float atomics: the same bits twice
                again = maxsim._launch_bwd(tt, ii, g, mode, text_mask)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"[3 kernels] maxsim bwd {mode} {dtype}: two runs "
                    f"{'equal bit for bit' if same else 'DIFFER'} (dT, dI)")
                if not same:
                    raise RuntimeError("two runs of the maxsim backward differ")
                del again
            del got, want
        if dtype == torch.bfloat16:
            inputs["maxsim_bwd"] = (tt, ii, g, text_mask)

    # token counts the first kernels refused: three column groups, 19 tie words
    mk, lt, li, d = MAXSIM_LONG
    t = torch.nn.functional.normalize(torch.randn(mk, lt, d, generator=gen), dim=-1)
    t[:, lt // 2:] = 0
    img = torch.nn.functional.normalize(torch.randn(mk, li, d, generator=gen), dim=-1)
    gs = torch.randn(mk, mk, generator=gen) / mk
    for dtype in (torch.float32, torch.bfloat16):
        tt, ii, g = t.to(dev, dtype), img.to(dev, dtype), gs.to(dev)
        errs["maxsim_fwd"] = max(errs["maxsim_fwd"],
                                 check_maxsim_forward(tt, ii, "nonzero", None, "long"))
        got = maxsim._launch_bwd(tt, ii, g, "nonzero", None)
        want = maxsim.maxsim_bwd_plain(tt, ii, g)
        torch.cuda.synchronize()
        err = max(max_rel_err(a, w) for a, w in zip(got, want))
        tol = BWD_TOL[str(dtype).split(".")[-1]]
        log(f"[3 kernels] maxsim bwd long M=K={mk} Lt={lt} Li={li} D={d} {dtype}: "
            f"max_abs_err / max|grad| {err:.3g} (tol {tol}) (dT, dI)")
        if not err <= tol:
            raise RuntimeError(f"maxsim bwd Lt={lt} Li={li} {dtype}: {err} > {tol}")
        errs["maxsim_bwd"] = max(errs["maxsim_bwd"], err)
        del got, want
    return errs, inputs


def check_maxsim_forward(text, image, mode, text_mask, label: str) -> float:
    """The MaxSim forward kernel against its plain version; returns the error."""
    import torch

    from colxlip_tpu_torch.ops import maxsim

    got = maxsim._launch_fwd(text, image, mode, text_mask)
    want = maxsim.maxsim_plain(text, image, mask_mode=mode, text_mask=text_mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    (m, lt, d), (k, li, _) = text.shape, image.shape
    log(f"[3 kernels] maxsim {label} {mode} M={m} K={k} Lt={lt} Li={li} D={d} "
        f"{str(text.dtype).split('.')[-1]}: max_abs_err {err:.3g} (tol {MAXSIM_TOL})")
    if not (err <= MAXSIM_TOL and torch.isfinite(got).all()):
        raise RuntimeError(f"maxsim {label} {mode} {text.dtype}: {err} > {MAXSIM_TOL}")
    return err


def maxsim_pass_ms(tt, ii, g, calls: int = 3):
    """Device ms a call of each kernel of the MaxSim forward (max, mean) and
    backward (route, coef, dT, dI) at the training shape (torch.profiler)."""
    import torch

    from colxlip_tpu_torch.ops import maxsim

    out = {}
    for fn in (lambda: maxsim._launch_fwd(tt, ii, "nonzero", None),
               lambda: maxsim._launch_bwd(tt, ii, g, "nonzero", None)):
        events, _ = profiled(lambda: [fn() for _ in range(calls)])
        for e in events:
            found = re.search(r"maxsim_(?:bwd_)?(\w+?)_kernel", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and found:
                out[found.group(1)] = e.self_device_time_total / 1e3 / calls
    return out


def synthetic_batch(n: int, image_size: int, ctx: int, seed: int):
    """Seeded NHWC float images and token ids laid out like bench.py's:
    SOT, 19 random ids, EOT at column 20, zeros after."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, image_size, image_size, 3)).astype(np.float32)
    texts = np.zeros((n, ctx), np.int64)
    texts[:, 0] = 49406
    texts[:, 1:20] = rng.integers(1, 49000, (n, 19))
    texts[:, 20] = 49407
    return images, texts


def compare_step(dev, dtype, ref_state, step_cfg, images, texts, tag: str = "[6 train]",
                 model_name: str = MODEL, make_step=None) -> None:
    """One train step (learning rate 0) through the kernels and through the
    plain versions on the same weights and inputs; raises on disagreement.
    ``ref_state`` None keeps ``model_name``'s seed-0 weights. A tensor
    whose gradient (plain versions) has a norm under VANISHING_GRAD of the
    step's largest has no direction to compare: it is held to a difference
    under VANISHING_GRAD of the largest instead of the cosine and the norm
    (CoCa at random init: the key bias of every attention, whose gradient
    is zero by construction, and the query-side LayerNorm of the decoder's
    cross blocks, whose keys, the pooled image slots, are alike, read
    1e-6 of the largest in bf16 and 3e-10 in fp32). ``make_step(model,
    optimizer, schedule, cfg)`` builds the step (default make_train_step)."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    make_step = make_step or make_train_step
    results = []
    for plain in (False, True):
        model, _ = create_model(model_name, dev, dtype, seed=0)
        if ref_state is not None:
            model.load_state_dict(ref_state)
        model.train()
        zero = const_lr(0.0, 0)
        step = make_step(model, create_optimizer(model, zero), zero, step_cfg)
        with plain_versions() if plain else contextlib.nullcontext():
            metrics = step(images, texts)
        grads = {k: p.grad.float() for k, p in model.named_parameters()}
        results.append(({k: float(v) for k, v in metrics.items()}, grads))
        del step, model
    (m_k, g_k), (m_p, g_p) = results
    cos_min, norm_tol, loss_tol = STEP_TOL[str(dtype).split(".")[-1]]
    loss_err = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p)
    cosines, norm_err, vanishing = {}, 0.0, {}
    largest = max(w.norm().item() for w in g_p.values())
    for name, w in g_p.items():
        g = g_k[name]
        nw, ng = w.norm().item(), g.norm().item()
        if nw == 0 and ng == 0:
            continue
        if nw < VANISHING_GRAD * largest:
            vanishing[name] = (g - w).norm().item() / largest
            continue
        cosines[name] = (g * w).sum().item() / max(nw * ng, 1e-30)
        norm_err = max(norm_err, abs(ng - nw) / max(nw, 1e-30))
    worst = sorted(cosines, key=cosines.get)[:3]
    log(f"{tag} batch {images.shape[0]} step in {dtype}, kernels vs plain versions: "
        + " ".join(f"{k} {m_k[k]:.5f}/{m_p[k]:.5f}" for k in m_p)
        + f"; max rel loss diff {loss_err:.3g} (tol {loss_tol}); lowest per-tensor grad "
        f"cosines " + ", ".join(f"{n} {cosines[n]:.5f}" for n in worst)
        + f" (min {cos_min}); max rel per-tensor grad-norm diff {norm_err:.3g} "
        f"(tol {norm_tol}); {len(g_p)} tensors"
        + (f"; {len(vanishing)} with a gradient under {VANISHING_GRAD} of the largest, "
           f"largest difference {max(vanishing.values()):.3g} of it (tol {VANISHING_GRAD})"
           if vanishing else ""))
    if not (loss_err <= loss_tol and cosines[worst[0]] >= cos_min and norm_err <= norm_tol
            and all(v <= VANISHING_GRAD for v in vanishing.values())):
        raise RuntimeError(f"the {dtype} train step through the kernels disagrees with "
                           "the plain versions")


def profile_step(step, images, texts, card: str, tag: str = "[6 train]") -> None:
    """Device time of one step by kernel, and the device's idle share of it
    (torch.profiler; the step's wall time includes the profiler's cost)."""
    import torch

    events, wall_ms = profiled(lambda: step(images, texts))
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"{tag} profiled step: {device_ms:.1f} ms of kernels in {wall_ms:.1f} ms "
        f"(device idle {max(0.0, 1 - device_ms / wall_ms):.1%}) ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d} x  "
            f"{e.key[:90]}")


def train_phase(dev, card: str):
    """Phase 6: the one-GPU train step at full ViT-B-16-colxlip width."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import cosine_lr

    t0 = time.perf_counter()
    model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    model.train()
    ref_state = copy.deepcopy(model.state_dict())
    size = cfg.vision_cfg.image_size
    images, texts = synthetic_batch(TRAIN_BATCH, size, cfg.text_cfg.context_length, seed=0)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = cosine_lr(2e-4, 2, TRAIN_STEPS)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6 train] {MODEL} random init (seed 0) on {dev}: {n_params / 1e6:.1f} M fp32 "
        f"params, bf16 compute, colclip (alpha 0.5, mask nonzero), AdamW cosine_lr(2e-4, "
        f"warmup 2, {TRAIN_STEPS} steps), batch {TRAIN_BATCH} x {size}px / "
        f"{cfg.text_cfg.context_length} tokens; built in {time.perf_counter() - t0:.1f} s")

    counters = {"fused_attention_fwd": attention.LAUNCHES, "fused_attention_bwd":
                attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}
    unused = fused_counters()
    for c in (*counters.values(), *unused.values()):
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        log(f"[6 train] step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f" | {secs[-1] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[6 train] kernel launches over {TRAIN_STEPS} steps: {launches}")
    check_default_path(unused, "phase 6")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the train step was never launched: {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_ms = statistics.median(secs[2:]) * 1e3
    log(f"[6 train] loss {losses[0]:.5f} -> {losses[-1]:.5f}; step at batch {TRAIN_BATCH}: "
        f"median {step_ms:.2f} ms over steps 2..{TRAIN_STEPS - 1} = "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s; peak device memory {peak:.2f} GiB ({card})")

    profile_step(step, images, texts, card)
    del step, model
    torch.cuda.empty_cache()

    # the same step through the kernels and through the plain versions, at
    # batch COMPARE_BATCH (the plain attention backward holds [B, H, N, N]),
    # in fp32 and in bf16 compute
    for dtype in (torch.float32, torch.bfloat16):
        compare_step(dev, dtype, ref_state, step_cfg, images[:COMPARE_BATCH],
                     texts[:COMPARE_BATCH])
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "losses": losses}


def vit_l_phase(dev, card: str):
    """Phase 6b: ViT-L-14-colxlip (257 image tokens) encodes and trains."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    t0 = time.perf_counter()
    model, cfg = create_model(VIT_L_MODEL, dev, torch.bfloat16, seed=0)
    vis, txt = cfg.vision_cfg, cfg.text_cfg
    images, texts = synthetic_batch(VIT_L_BATCH, vis.image_size, txt.context_length, seed=2)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6b vit-l] {VIT_L_MODEL} random init (seed 0) on {dev}: {n_params / 1e6:.1f} M fp32 "
        f"params, bf16 compute, {vis.layers} + {txt.layers} blocks, {vis.num_patches + 1} image "
        f"tokens, batch {VIT_L_BATCH}; built in {time.perf_counter() - t0:.1f} s")
    counters = {"fused_attention_fwd": attention.LAUNCHES, "fused_attention_bwd":
                attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}

    def reset():
        for c in counters.values():
            c.reset()

    # (a) the encoders through the attention kernel and through its plain version
    model.eval()
    with torch.inference_mode():
        for encode, batch, layers in (("encode_image", images, vis.layers),
                                      ("encode_text", texts, txt.layers)):
            reset()
            got = getattr(model, encode)(batch, normalize=True)
            torch.cuda.synchronize()
            launched = attention.LAUNCHES.value
            with plain_versions():
                want = getattr(model, encode)(batch, normalize=True)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            off = max(((1.0 - torch.nn.functional.cosine_similarity(
                g.float(), w.float(), dim=-1)) * (w.float().norm(dim=-1) > 0.5)).max().item()
                for g, w in zip(got, want))
            log(f"[6b vit-l] {encode} batch {VIT_L_BATCH} vs the plain attention, unit-norm "
                f"pooled and token features {[tuple(g.shape) for g in got]}: max_abs_err "
                f"{err:.3g} (tol {ENCODE_TOL}), largest 1 - cosine of a row {off:.3g} (tol "
                f"{ENCODE_COSINE_TOL}); {launched} attention launches")
            if launched != layers:
                raise RuntimeError(f"{encode}: {launched} attention launches, expected {layers}")
            if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL
                    and all(torch.isfinite(g).all() for g in got)):
                raise RuntimeError(f"{VIT_L_MODEL} {encode}: max_abs_err {err}, 1 - cosine {off}")

    # (b) colclip train steps on one fixed batch
    model.train()
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = const_lr(1e-4, 0)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(VIT_L_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        log(f"[6b vit-l] step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f" | {secs[-1] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"{VIT_L_MODEL} step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    blocks = vis.layers + txt.layers
    want_launches = {"fused_attention_fwd": VIT_L_STEPS * blocks,
                     "fused_attention_bwd": VIT_L_STEPS * blocks,
                     "maxsim_fwd": VIT_L_STEPS, "maxsim_bwd": VIT_L_STEPS}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[6b vit-l] loss {losses[0]:.5f} -> {losses[-1]:.5f} over {VIT_L_STEPS} steps at batch "
        f"{VIT_L_BATCH} (last step {secs[-1] * 1e3:.1f} ms, peak device memory {peak:.2f} GiB); "
        f"kernel launches {launches} ({card})")
    if launches != want_launches:
        raise RuntimeError(f"{VIT_L_MODEL}: launches {launches}, expected {want_launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{VIT_L_MODEL}: the loss did not fall: {losses}")
    del step, model
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_ms": secs[-1] * 1e3,
            "peak_gib": peak}


def fused_phase(dev, card: str, train):
    """Phase 8: both towers through the LayerNorm and MLP kernels, serving
    and training, at full ViT-B-16-colxlip width and depth."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    default_model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    with fused_towers():
        model, _ = create_model(MODEL, dev, torch.bfloat16, seed=0)
    ref_state = copy.deepcopy(model.state_dict())
    size, ctx = cfg.vision_cfg.image_size, cfg.text_cfg.context_length
    images, texts = synthetic_batch(TRAIN_BATCH, size, ctx, seed=0)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)
    new = fused_counters()
    counters = {**new, "fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}

    def reset():
        for c in counters.values():
            c.reset()

    # (a) serving: the same weights through the kernels and the default path
    with torch.inference_mode():
        for kind, batch in (("image", images[:MAX_BATCH]), ("text", texts[:MAX_BATCH])):
            encode = "encode_image" if kind == "image" else "encode_text"
            reset()
            got = getattr(model, encode)(batch, normalize=True)
            torch.cuda.synchronize()
            launches = {name: c.value for name, c in new.items()}
            want_launches = {"fused_ln_fwd": ENCODE_LN_LAUNCHES[kind], "fused_ln_bwd": 0,
                             "fused_mlp_fwd": TOWER_LAYERS, "fused_mlp_bwd": 0}
            want = getattr(default_model, encode)(batch, normalize=True)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            # text tokens at and after EOT are zero rows on both paths: they
            # have no direction and are held by the element bar alone
            off = max(((1.0 - torch.nn.functional.cosine_similarity(
                g.float(), w.float(), dim=-1)) * (w.float().norm(dim=-1) > 0.5)).max().item()
                for g, w in zip(got, want))
            log(f"[8 fused] {encode} batch {MAX_BATCH} through the kernels vs the default "
                f"path, unit-norm pooled and token features: max_abs_err {err:.3g} (tol "
                f"{ENCODE_TOL}), largest 1 - cosine of a row {off:.3g} (tol "
                f"{ENCODE_COSINE_TOL}); launches {launches}")
            if launches != want_launches:
                raise RuntimeError(f"{encode}: launches {launches}, expected {want_launches}")
            if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL
                    and all(torch.isfinite(g).all() for g in got)):
                raise RuntimeError(f"{encode} through the kernels: max_abs_err {err} (tol "
                                   f"{ENCODE_TOL}), 1 - cosine {off} (tol {ENCODE_COSINE_TOL})")
        # the uint8 feed: normalised on the device against normalised on the host
        rng = np.random.default_rng(1)
        raw = rng.integers(0, 256, (MAX_BATCH, size, size, 3), dtype=np.uint8)
        mean = np.asarray(cfg.vision_cfg.image_mean, np.float32)
        std = np.asarray(cfg.vision_cfg.image_std, np.float32)
        host = (raw.astype(np.float32) / np.float32(255.0) - mean) / std
        got = model.encode_image(torch.from_numpy(raw).to(dev), normalize=True)
        want = model.encode_image(torch.from_numpy(host).to(dev), normalize=True)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"[8 fused] encode_image on a uint8 batch of {MAX_BATCH} (normalised on the "
            f"device in fp32) vs the same batch normalised on the host: "
            f"{'equal bit for bit' if same else 'NOT equal'}")
        if not same:
            raise RuntimeError("the uint8 feed disagrees with the host-normalised batch")
    del default_model
    torch.cuda.empty_cache()

    # (b) training: FUSED_STEPS colclip steps at batch 256 on one fixed batch
    model.train()
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = const_lr(1e-4, 0)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(FUSED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        log(f"[8 fused] step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f" | {secs[-1] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want_launches = {name: FUSED_STEPS * STEP_LAUNCHES[name.rsplit("_", 1)[0]]
                     for name in counters}
    log(f"[8 fused] kernel launches over {FUSED_STEPS} steps: {launches}")
    if launches != want_launches:
        raise RuntimeError(f"launches {launches}, expected {want_launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {FUSED_STEPS} steps: {losses}")
    step_ms = statistics.median(secs[1:]) * 1e3
    # autograd on the default path keeps two [B, N, H] tensors an MLP (the
    # pre-activation for GELU's backward, the activation for c_proj's); the
    # kernels keep none, so the peak must fall by (at least 90% of) their bytes
    vis, txt = cfg.vision_cfg, cfg.text_cfg
    hidden_elements = TRAIN_BATCH * (
        vis.layers * (vis.num_patches + 1) * int(vis.width * vis.mlp_ratio)
        + txt.layers * ctx * int(txt.width * txt.mlp_ratio))
    hidden_gib = 2 * 2 * hidden_elements / 2**30        # two tensors an MLP, bf16
    limit = train["peak_gib"] - 0.9 * hidden_gib
    log(f"[8 fused] loss {losses[0]:.5f} -> {losses[-1]:.5f}; step at batch {TRAIN_BATCH}: "
        f"median {step_ms:.2f} ms over steps 1..{FUSED_STEPS - 1} = "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s (default path, phase 6: "
        f"{train['step_ms']:.2f} ms); peak device memory {peak:.2f} GiB against "
        f"{train['peak_gib']:.2f} GiB in phase 6, whose 48 hidden tensors are {hidden_gib:.2f} "
        f"GiB (limit {limit:.2f} GiB) ({card})")
    if not peak <= limit:
        raise RuntimeError(f"peak {peak} GiB with the fused MLP is above {limit} GiB: a "
                           "[B, N, H] tensor was held")
    ratio = step_ms / train["step_ms"]
    log(f"[8 fused] the fused-towers step is {ratio:.3f} x the default step (at most "
        f"{FUSED_STEP_RATIO_MAX})")
    if not ratio <= FUSED_STEP_RATIO_MAX:
        raise RuntimeError(f"the fused-towers step {step_ms:.2f} ms is {ratio:.3f} x the default "
                           f"step {train['step_ms']:.2f} ms (at most {FUSED_STEP_RATIO_MAX})")
    profile_step(step, images, texts, card, tag="[8 fused]")
    del step, model
    torch.cuda.empty_cache()

    # (c) the batch-64 step through the kernels and through the plain versions
    with fused_towers():
        for dtype in (torch.float32, torch.bfloat16):
            compare_step(dev, dtype, ref_state, step_cfg, images[:COMPARE_BATCH],
                         texts[:COMPARE_BATCH], tag="[8 fused]")
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak, "losses": losses}


def ln_only_phase(dev, card: str, train):
    """Phase 6c: the flagship step of phase 6 with COLXLIP_LN_IMPL=fused alone
    (LayerNorm kernels #7-8 in both towers, the MLPs on the library path),
    TRAIN_STEPS steps at batch 256 on the same batch and schedule, against
    phase 6's step."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, fused_ln, fused_mlp, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import cosine_lr

    with fused_towers(("COLXLIP_LN_IMPL",)):
        model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    model.train()
    images, texts = synthetic_batch(TRAIN_BATCH, cfg.vision_cfg.image_size,
                                    cfg.text_cfg.context_length, seed=0)
    images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = cosine_lr(2e-4, 2, TRAIN_STEPS)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    counters = {"fused_ln_fwd": fused_ln.FWD_LAUNCHES, "fused_ln_bwd": fused_ln.BWD_LAUNCHES,
                "fused_mlp_fwd": fused_mlp.FWD_LAUNCHES, "fused_mlp_bwd": fused_mlp.BWD_LAUNCHES,
                "fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"[6c] step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    per_step = {**STEP_LAUNCHES, "fused_mlp": 0}
    want = {name: TRAIN_STEPS * per_step[name.rsplit("_", 1)[0]] for name in counters}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = statistics.median(secs[2:]) * 1e3
    log(f"[6c ln] {MODEL} with COLXLIP_LN_IMPL=fused alone: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} (phase 6: {train['losses'][0]:.5f} -> {train['losses'][-1]:.5f}); "
        f"step at batch {TRAIN_BATCH}: median {step_ms:.2f} ms over steps 2..{TRAIN_STEPS - 1} = "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s against phase 6's {train['step_ms']:.2f} ms "
        f"({step_ms / train['step_ms']:.3f} x); peak device memory {peak:.2f} GiB (phase 6: "
        f"{train['peak_gib']:.2f}); kernel launches over {TRAIN_STEPS} steps {launches} ({card})")
    if launches != want:
        raise RuntimeError(f"[6c] launches {launches}, expected {want}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"[6c] the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    profile_step(step, images, texts, card, tag="[6c ln]")
    del step, model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak, "losses": losses,
            "over_default": step_ms / train["step_ms"]}


def vit_l_fused_phase(dev, card: str, vit_l):
    """Phase 8b: ViT-L-14-colxlip (vision 1024 wide, 24 blocks; text 768, 12)
    through the LayerNorm and MLP kernels, the first model path that runs #8
    at D = 1024: both encoders at batch VIT_L_BATCH against the same weights
    on the default path, then VIT_L_STEPS colclip steps with exact launch
    counts, and the peak memory against phase 6b's."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    default_model, cfg = create_model(VIT_L_MODEL, dev, torch.bfloat16, seed=0)
    with fused_towers():
        model, _ = create_model(VIT_L_MODEL, dev, torch.bfloat16, seed=0)
    vis, txt = cfg.vision_cfg, cfg.text_cfg
    images, texts = synthetic_batch(VIT_L_BATCH, vis.image_size, txt.context_length, seed=2)
    images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
    new = fused_counters()
    counters = {**new, "fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}
    # LayerNorms an encode: ln_1 and ln_2 a block and the token head's two,
    # with ln_pre and ln_post in the vision tower and ln_final in the text's
    layer_norms = {"image": 2 * vis.layers + 4, "text": 2 * txt.layers + 3}
    blocks = {"image": vis.layers, "text": txt.layers}

    def reset():
        for c in counters.values():
            c.reset()

    model.eval()
    with torch.inference_mode():
        for kind, batch in (("image", images), ("text", texts)):
            encode = "encode_image" if kind == "image" else "encode_text"
            reset()
            got = getattr(model, encode)(batch, normalize=True)
            torch.cuda.synchronize()
            launches = {name: c.value for name, c in new.items()}
            want_launches = {"fused_ln_fwd": layer_norms[kind], "fused_ln_bwd": 0,
                             "fused_mlp_fwd": blocks[kind], "fused_mlp_bwd": 0}
            want = getattr(default_model, encode)(batch, normalize=True)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            off = max(((1.0 - torch.nn.functional.cosine_similarity(
                g.float(), w.float(), dim=-1)) * (w.float().norm(dim=-1) > 0.5)).max().item()
                for g, w in zip(got, want))
            log(f"[8b vit-l fused] {encode} batch {VIT_L_BATCH} through the kernels vs the "
                f"default path: max_abs_err {err:.3g} (tol {ENCODE_TOL}), largest 1 - cosine of "
                f"a row {off:.3g} (tol {ENCODE_COSINE_TOL}); launches {launches}")
            if launches != want_launches:
                raise RuntimeError(f"[8b] {encode}: launches {launches}, expected {want_launches}")
            if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL
                    and all(torch.isfinite(g).all() for g in got)):
                raise RuntimeError(f"[8b] {encode}: max_abs_err {err}, 1 - cosine {off}")
    del default_model
    torch.cuda.empty_cache()

    model.train()
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = const_lr(1e-4, 0)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(VIT_L_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"[8b] step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    per_step = {"fused_ln": sum(layer_norms.values()), "fused_mlp": sum(blocks.values()),
                "fused_attention": sum(blocks.values()), "maxsim": 1}
    want_launches = {name: VIT_L_STEPS * per_step[name.rsplit("_", 1)[0]] for name in counters}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[8b vit-l fused] loss {losses[0]:.5f} -> {losses[-1]:.5f} over {VIT_L_STEPS} steps at "
        f"batch {VIT_L_BATCH} (last step {secs[-1] * 1e3:.1f} ms against phase 6b's "
        f"{vit_l['step_ms']:.1f} ms; peak device memory {peak:.2f} GiB against phase 6b's "
        f"{vit_l['peak_gib']:.2f} GiB); kernel launches {launches} ({card})")
    if launches != want_launches:
        raise RuntimeError(f"[8b] launches {launches}, expected {want_launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"[8b] the loss did not fall: {losses}")
    if not peak < vit_l["peak_gib"]:
        raise RuntimeError(f"[8b] peak {peak} GiB through the kernels is not below the default "
                           f"path's {vit_l['peak_gib']} GiB (the MLPs hold no hidden tensors)")
    del step, model
    torch.cuda.empty_cache()
    fp32 = vit_l_fused_fp32_step(dev, card, step_cfg, images, texts,
                                 {name: n // VIT_L_STEPS for name, n in launches.items()})
    return {"launches": launches, "losses": losses, "step_ms": secs[-1] * 1e3, "peak_gib": peak,
            "fp32": fp32}


def vit_l_fused_fp32_step(dev, card: str, step_cfg, images, texts, want_launches) -> dict:
    """Phase 8b, fp32: one ViT-L-14-colxlip step at batch VIT_L_BATCH with
    both variables 'fused' and fp32 compute, the MLP kernels past D = 768 in
    their feature slices: exact launches (79 LayerNorm, 36 MLP and 36
    attention each way, 1 MaxSim), its ms and peak; then the step against
    the plain versions on the same weights under phase 6's fp32 bars."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    counters = gspmd_counters()
    with fused_towers():
        model, _ = create_model(VIT_L_MODEL, dev, torch.float32, seed=0)
        model.train()
        zero = const_lr(0.0, 0)
        step = make_train_step(model, create_optimizer(model, zero), zero, step_cfg)
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(images, texts).items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        launches = {name: c.value for name, c in counters.items()}
        del step, model
        torch.cuda.empty_cache()
        log(f"[8b vit-l fused fp32] {VIT_L_MODEL} fp32 step at batch {VIT_L_BATCH} through the "
            f"kernels: total_loss {metrics['total_loss']:.5f}, {ms:.1f} ms (the first step, "
            f"the MLP kernels on the CUDA cores), peak device memory {peak:.2f} GiB; launches "
            f"{launches} ({card})")
        if launches != want_launches or not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"[8b] fp32: launches {launches}, expected {want_launches}; "
                               f"metrics {metrics}")
        compare_step(dev, torch.float32, None, step_cfg, images, texts,
                     tag="[8b vit-l fused fp32]", model_name=VIT_L_MODEL)
    return {"step_ms": ms, "peak_gib": peak, "launches": launches, "loss": metrics["total_loss"]}


def main_phase(dev, card: str, flickr_root: str, n_texts: int, n_images: int):
    """Phase 7: train ViT-B-16 through the port's training entry point, with
    the Flickr30k suite evaluated at the end of every epoch."""
    import torch

    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.ops import attention, fused_ce
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    counters = {"fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES,
                "fused_ce_fwd": fused_ce.FWD_LAUNCHES,
                "fused_ce_bwd_da": fused_ce.BWD_DA_LAUNCHES,
                "fused_ce_bwd_db": fused_ce.BWD_DB_LAUNCHES}
    steps = 2 * MAIN_STEPS_PER_EPOCH
    with tempfile.TemporaryDirectory() as logs:
        argv = ["--model", MAIN_MODEL, "--dataset-type", "synthetic", "--batch-size",
                str(TRAIN_BATCH), "--precision", "bf16", "--ce-impl", "fused", "--epochs", "2",
                "--steps-per-epoch", str(MAIN_STEPS_PER_EPOCH), "--log-every-n-steps", "1",
                "--save-frequency", "1", "--workers", "0", "--seed", "0", "--logs", logs,
                "--name", "smoke", "--retrieval-flickr", "--flickr-data-root-dir", flickr_root,
                "--val-frequency", "1"]
        log(f"[7 main] python -m colxlip_tpu_torch.main {' '.join(argv)}")
        unused = fused_counters()
        for c in (*counters.values(), *unused.values()):
            c.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            rc = entry.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {name: c.value for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            if rc != 0:
                raise RuntimeError(f"main returned {rc}")
            base = os.path.join(logs, "smoke")
            for rel in ("checkpoints/epoch_1/state.pt", "checkpoints/epoch_2/state.pt",
                        "params.txt", "out.log", "metrics.jsonl"):
                if not os.path.exists(os.path.join(base, rel)):
                    raise RuntimeError(f"main wrote no {rel}")

            def records():
                with open(os.path.join(base, "metrics.jsonl")) as f:
                    return [json.loads(line) for line in f]

            recs = records()
            losses = [r["total_loss"] for r in recs]
            if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
                    math.isfinite(x) for x in losses):
                raise RuntimeError(f"main logged {[(r['step'], r['total_loss']) for r in recs]}")
            if abs(losses[0] - math.log(TRAIN_BATCH)) > 0.5:
                raise RuntimeError(f"loss at step 1 is {losses[0]}, not near ln {TRAIN_BATCH}")
            layers = 24   # 12 blocks in each tower
            evals = 2     # one at the end of each epoch
            want = {"fused_attention_fwd": layers * steps + evals * encode_launches(
                        n_texts, n_images, TRAIN_BATCH), "fused_attention_bwd": layers * steps,
                    "fused_ce_fwd": 2 * steps, "fused_ce_bwd_da": 2 * steps,
                    "fused_ce_bwd_db": 2 * steps}
            log(f"[7 main] rc 0 in {secs:.1f} s; kernel launches over {steps} steps and {evals} "
                f"epoch-end evals: {launches}")
            results = read_results(base)
            if [r["epoch"] for r in results] != [1, 2]:
                raise RuntimeError(f"results.jsonl epochs {[r['epoch'] for r in results]}")
            with open(os.path.join(base, "out.log")) as f:
                split = re.findall(r"flickr seconds: (.*)", f.read())
            log(f"[7 main] epoch-end eval, Flickr30k val {n_texts} x {n_images}, global "
                f"scoring: epoch 2 {r_at_k(results[-1], 'flickr_')}; {split[-1]} ({card})")
            if launches != want:
                raise RuntimeError(f"launches {launches}, expected {want}")
            check_default_path(unused, "phase 7")
            steady = recs[2:]
            step_ms = statistics.median(r["batch_time"] for r in steady) * 1e3
            data_ms = statistics.median(r["data_time"] for r in steady) * 1e3
            log(f"[7 main] {MAIN_MODEL} clip loss, --ce-impl fused, batch {TRAIN_BATCH}, bf16: "
                f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; step median {step_ms:.2f} ms = "
                f"{TRAIN_BATCH / step_ms * 1e3:.1f} samples/s over steps 3..{steps} (metrics "
                f"read every step); data_time median {data_ms:.2f} ms; peak device memory "
                f"{peak:.2f} GiB ({card})")

            resume = [*argv, "--resume", "latest", "--profile-dir", os.path.join(logs, "trace")]
            resume[resume.index("--epochs") + 1] = "3"
            rc = entry.main(resume)
            torch.cuda.synchronize()
            with open(os.path.join(base, "out.log")) as f:
                out_log = f.read()
            recs = records()
            if rc != 0 or not os.path.exists(os.path.join(base, "checkpoints/epoch_3/state.pt")):
                raise RuntimeError(f"--resume latest: rc {rc}, or no epoch_3")
            if ("epoch_2' (epoch 2)" not in out_log
                    or [r["step"] for r in recs] != list(range(1, steps + 7))):
                raise RuntimeError("--resume latest did not go on from epoch_2 at step 13")
            results = read_results(base)
            if [r["epoch"] for r in results] != [1, 2, 3] or not all(
                    math.isfinite(r["flickr_text_to_image_mean_rank"]) for r in results):
                raise RuntimeError(f"results.jsonl after the resume: {results}")
            idle = re.findall(r"profiled steps: .*", out_log)
            if not idle:
                raise RuntimeError("the profiled steps logged no device time")
            log(f"[7 main] --epochs 3 --resume latest: went on from epoch_2 at step "
                f"{steps + 1}, wrote epoch_3; loss {recs[-1]['total_loss']:.5f}; {idle[-1]} "
                f"({card})")
        finally:
            setup_logging(None)   # drop the handler on the log file that is going away
    torch.cuda.empty_cache()
    feed_ms = time_host_feed(dev)
    log(f"[7 main] host feed for one batch of {TRAIN_BATCH}: the synthetic generator "
        f"{feed_ms[0]:.1f} ms (one thread), pinned staging + copy to the card "
        f"{feed_ms[1]:.1f} ms the first time, {feed_ms[2]:.1f} ms after ({card})")
    return {"launches": launches, "step_ms": step_ms, "data_ms": data_ms, "peak_gib": peak,
            "device_idle": idle[-1], "feed_ms": feed_ms}


def read_results(base: str) -> list:
    with open(os.path.join(base, "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def time_host_feed(dev):
    """Host ms to (generate one synthetic batch, ship it cold, ship it warm)
    at phase 7's size, each stage alone on an idle machine."""
    import torch

    from colxlip_tpu_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from colxlip_tpu_torch.training.train import _PrefetchIterator

    def ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    data = iter(SyntheticDataset(SyntheticConfig(
        batch_size=TRAIN_BATCH, num_sampled_captions=8, seed=0, num_samples=2 * TRAIN_BATCH)))
    batch, gen_ms = ms(lambda: next(data))
    feed = _PrefetchIterator([], device=dev)
    try:
        prepared = feed._prep(*batch)
        _, cold = ms(lambda: feed._feeder(*prepared))
        _, warm = ms(lambda: feed._feeder(*prepared))
    finally:
        feed.close()
    return gen_ms, cold, warm


def check_quantizer(dev, gen):
    """Phase 3e: the int8 quantizer kernel against its plain version, bit for
    bit. Returns (largest |difference| in int8 steps or in a scale: 0.0, the
    inputs for the timings)."""
    import torch

    from colxlip_tpu_torch.ops import quantization as q

    cases = [(f"{k}x{n}", k, n, False, gen) for k, n in QUANT_SHAPES]
    cases.append(("512x512 zero column, +-absmax column", 512, 512, True, gen))
    tall = torch.Generator().manual_seed(QUANT_TALL_SEED)
    cases += [(f"{k}x{n} (tall)", k, n, False, tall) for k, n in QUANT_TALL_SHAPES]
    worst, inputs = 0.0, {}
    for label, k, n, special, case_gen in cases:
        base = (torch.randn(k, n, generator=case_gen) * k ** -0.5).to(dev)   # a layer's scale
        if special:
            base[:, 0] = 0.0
            base[:, 1] = base[:, 1].clamp(-0.09, 0.09)
            base[3, 1], base[7, 1] = 0.09, -0.09         # +-absmax: +-127 after scaling
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            w = base.to(dtype)
            runs = {seed: q._launch(w, seed) for seed in (0, 1)}
            again = q._launch(w, 0)
            rtn_values, rtn_scales = q.quantize_int8_rtn(w)
            mismatched = 0
            for seed, (values, scales) in runs.items():
                want_values, want_scales = q.quantize_int8_plain(w, seed)
                torch.cuda.synchronize()
                mismatched += int((values != want_values).sum()) + int(
                    (scales != want_scales).sum())
                worst = max(worst, (values.int() - want_values.int()).abs().max().item(),
                            (scales - want_scales).abs().max().item())
                step = (values.int() - rtn_values.int()).abs().max().item()
                if not (torch.equal(scales, rtn_scales) and step <= 1):
                    raise RuntimeError(f"quantize_int8 {label} {name} seed {seed}: scales "
                                       f"differ from round-to-nearest's, or {step} steps from it")
            differ = (runs[0][0] != runs[1][0]).float().mean().item()
            log(f"[3 kernels] quantize_int8 {label} {name}: seeds 0 and 1 against the plain "
                f"version: {mismatched} values or scales differ (must be 0); one seed twice "
                f"equal; {differ:.1%} of the values differ between the seeds; scales equal to "
                f"round-to-nearest's, values within 1 step")
            if mismatched or not torch.equal(runs[0][0], again[0]) or differ == 0:
                raise RuntimeError(f"quantize_int8 {label} {name}: {mismatched} mismatches, or "
                                   "one seed not repeatable, or two seeds equal")
            if special:
                values = runs[0][0]
                if not ((values[:, 0] == 0).all() and values[3, 1] == 127
                        and values[7, 1] in (-127, -126) and runs[0][1][0, 0] == 1e-8):
                    raise RuntimeError(f"quantize_int8 {label} {name}: the zero column or "
                                       "the +-absmax elements are wrong")
            if (k, n) in ((768, 3072), (3072, 768), QUANT_TALL_SHAPES[0]):
                inputs[f"{k}x{n}/{name}"] = w

    # unbiasedness on the card. T = sum over seeds and elements of (value - x),
    # x = w / scale, has mean 0 and variance S * sum f (1 - f), f = frac(x)
    # (a draw is floor(x) + Bernoulli(f)): |T| <= 4 sqrt(that). Per element the
    # mean over S seeds has standard error sqrt(f (1 - f) / S). About 3e-4 of
    # an unbiased rounding's elements leave 4 of them (at f near 0 or 1 a
    # binomial over 64 draws has heavier tails than a normal: one rare draw is
    # 1 / 64), so at most 1e-3 may; a biased rounding puts most of them outside.
    w = inputs["768x3072/float32"]
    scale = q.quantize_int8_rtn(w)[1]
    x = (w / scale).double()
    total = torch.zeros_like(x)
    for seed in range(QUANT_SEEDS):
        total += q._launch(w, seed)[0].double()
    f = x - torch.floor(x)
    var = f * (1 - f)
    t_stat = (total - QUANT_SEEDS * x).sum().abs().item()
    t_bar = 4 * (QUANT_SEEDS * var.sum()).sqrt().item()
    se = (var / QUANT_SEEDS).sqrt().clamp_min(1e-6)
    outside = ((total / QUANT_SEEDS - x).abs() > 4 * se).double().mean().item()
    worst_w = ((total / QUANT_SEEDS * scale - w).abs() / scale).max().item()
    log(f"[3 kernels] quantize_int8 768x3072 fp32 over {QUANT_SEEDS} seeds: |sum of (value - "
        f"w / scale)| {t_stat:.1f} (4 standard deviations: {t_bar:.1f}); {outside:.2e} of the "
        f"elements' means lie outside 4 standard errors (limit 1e-3); the mean of value * scale "
        f"is within {worst_w:.3f} steps of w everywhere")
    if not (t_stat <= t_bar and outside <= 1e-3):
        raise RuntimeError("quantize_int8 is biased")
    return worst, inputs


def time_quantizer(inputs, card: str):
    """Phase 5: the quantizer kernel, its plain version and round-to-nearest
    from five PyTorch calls (amax, div, round, clamp, to; plus the scale's own
    division and clamp), with the bound by bytes."""
    import torch

    from colxlip_tpu_torch.ops import quantization as q

    def five_calls(w):
        x = w.float()
        scale = (x.abs().amax(dim=0, keepdim=True) / 127.0).clamp_min(1e-8)
        return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale

    timing, bounds = {}, {}
    for key, w in inputs.items():
        k, n = w.shape
        timing[f"quantize_int8/{key}"] = (
            cuda_ms(lambda: q._launch(w, 0), 50), cuda_ms(lambda: q.quantize_int8_plain(w, 0), 5, 1),
            cuda_ms(lambda: five_calls(w), 20))
        # read the weight once, write K N int8 and N scales; a division, an
        # add, a floor and two clips an element, and the absmax
        bounds[key] = bound_ms(k * n * w.element_size() + k * n + 4 * n, 6 * k * n,
                               "float32")
        ker, plain, lib = timing[f"quantize_int8/{key}"]
        log(f"[5 timing] quantize_int8 {key}: kernel {ker:.4f} ms, plain {plain:.4f} ms, "
            f"round-to-nearest from five PyTorch calls {lib:.4f} ms; bound {bounds[key][0]:.5f} "
            f"ms by {bounds[key][1]} ({card})")
    # a call's host side (two allocations, one ctypes call) apart from its
    # device side: the host clock around calls that never wait for the card,
    # and the profiler's device operations, which must be one kernel a call
    w = inputs["768x3072/float32"]
    calls = 200
    for _ in range(5):
        q._launch(w, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        q._launch(w, 0)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    log(f"[5 timing] quantize_int8 768x3072/float32 a call's host side: {host_ms * 1e3:.2f} us "
        f"(enqueue: {calls} calls that never wait for the card; {card})")
    for key, w in inputs.items():
        events, _ = profiled(lambda: [q._launch(w, 0) for _ in range(20)])
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = sum(e.count for e in device)
        names = sorted({"quantize_kernel" if "quantize_kernel" in e.key else e.key[:40]
                        for e in device})
        ms = sum(e.self_device_time_total for e in device) / 20 / 1e3 if device else None
        bound = bounds[key][0]
        log(f"[5 timing] quantize_int8 {key} device time a call: "
            + (f"{ms * 1e3:.2f} us, {bound / ms:.1%} of the bound {bound * 1e3:.2f} us "
               f"(torch.profiler, 20 calls: {ops} device operations {names})" if ms else
               "not measured (the profiler saw no device events)") + f" ({card})")
        if device and (ops != 20 or names != ["quantize_kernel"]):
            raise RuntimeError(f"quantize_int8 {key}: {ops} device operations in 20 calls "
                               f"({names}); one kernel a call expected")
        timing[f"quantize_int8_device_ms/{key}"] = ms
    timing["quantize_int8_device_ms"] = timing["quantize_int8_device_ms/768x3072/float32"]
    timing["quantize_int8_host_ms"] = host_ms
    return timing, bounds


def stochastic_tree(model, tree, tower: str):
    """``tree`` (quantize_vision_params / quantize_text_params of ``model``)
    with every Dense weight quantized anew by the quantizer kernel, seed =
    the layer's index: the kernel takes [in, out], the tree holds [out, in]."""
    from colxlip_tpu_torch.ops.quantization import quantize_int8

    sd = model.state_dict()
    seeds = iter(range(1000))

    def requant(node, weight_out_in):
        values, scales = quantize_int8(weight_out_in.detach().float().t().contiguous(),
                                       seed=next(seeds))
        return {**node, "q": values.t().contiguous(), "scale": scales[0]}

    out = dict(tree)
    if tower == "vision":
        conv = sd["visual.conv1.weight"]
        out["conv1"] = requant(tree["conv1"], conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1))
        out["proj"] = requant(tree["proj"], sd["visual.proj"].t())
        prefix = "visual.transformer.resblocks."
    else:
        out["text_projection"] = requant(tree["text_projection"], sd["text_projection"].t())
        prefix = "transformer.resblocks."
    names = {"in_proj": "attn.in_proj_weight", "out_proj": "attn.out_proj.weight",
             "c_fc": "mlp.c_fc.weight", "c_proj": "mlp.c_proj.weight"}
    out["blocks"] = [{**blk, **{name: requant(blk[name], sd[f"{prefix}{i}.{key}"])
                                for name, key in names.items()}}
                     for i, blk in enumerate(tree["blocks"])]
    return out


def int8_phase(dev, card: str, train, encode_ms):
    """Phase 9: the int8 slice and /v1/search at full width and depth."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.ops import quantization as q
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.serving import (
        quantize_text_params, quantize_vision_params, text_encode_int8, vision_encode_int8)
    from colxlip_tpu_torch.serving.index import RetrievalIndex, build_image_index
    from colxlip_tpu_torch.serving.server import ColXLIPService, make_server
    from colxlip_tpu_torch.training.evaluate import score_similarity
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    model.eval()
    size, ctx = cfg.vision_cfg.image_size, cfg.text_cfg.context_length
    images, texts = synthetic_batch(TRAIN_BATCH, size, ctx, seed=0)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)

    # (a) every Dense weight through the quantizer kernel, and round-to-nearest
    rtn = {"vision": quantize_vision_params(model), "text": quantize_text_params(model)}
    q.LAUNCHES.reset()
    stochastic, quant_launches = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tower in ("vision", "text"):
        before = q.LAUNCHES.value
        stochastic[tower] = stochastic_tree(model, rtn[tower], tower)
        quant_launches[tower] = q.LAUNCHES.value - before
    torch.cuda.synchronize()
    requant_ms = (time.perf_counter() - t0) * 1e3
    steps = max((a["q"].int() - b["q"].int()).abs().max().item()
                for tower in rtn for a, b in (
                    [(x[name], y[name]) for x, y in zip(stochastic[tower]["blocks"],
                                                        rtn[tower]["blocks"])
                     for name in ("in_proj", "out_proj", "c_fc", "c_proj")]))
    log(f"[9 int8] {MODEL} (seed 0): {q.LAUNCHES.value} Dense weights through the quantizer "
        f"kernel {quant_launches} in {requant_ms:.2f} ms (host clock, transposes included; "
        f"{card}); its values are within {steps} step of round-to-nearest's")
    if quant_launches != QUANT_LAUNCHES or steps > 1:
        raise RuntimeError(f"quantizer launches {quant_launches}, expected {QUANT_LAUNCHES}; "
                           f"or {steps} steps from round-to-nearest")

    # (b) both int8 encoders against the bf16 model on the same fp32 weights
    rates = {}
    with torch.inference_mode():
        batches = {"vision": images[:MAX_BATCH], "text": texts[:MAX_BATCH]}
        encoders = {"vision": (vision_encode_int8, lambda x: model.encode_image(x, normalize=True)),
                    "text": (text_encode_int8, lambda x: model.encode_text(x, normalize=True))}
        for tower, (encode_int8, encode) in encoders.items():
            batch = batches[tower]
            ref = encode(batch)[0].float()
            cosines = {}
            for label, tree in (("round-to-nearest", rtn[tower]), ("quantizer kernel",
                                                                   stochastic[tower])):
                attention.LAUNCHES.reset()
                got = encode_int8(cfg, tree, batch)
                torch.cuda.synchronize()
                launched = attention.LAUNCHES.value
                norm_err = (got.norm(dim=-1) - 1).abs().max().item()
                cosines[label] = (ref * got).sum(dim=-1).min().item()
                if launched != TOWER_LAYERS or got.dtype != torch.float32 or got.shape != ref.shape \
                        or not torch.isfinite(got).all() or norm_err > 1e-4:
                    raise RuntimeError(f"{tower} int8 encode ({label}): {launched} attention "
                                       f"launches (expected {TOWER_LAYERS}), or bad features")
            ms = cuda_ms(lambda: encode_int8(cfg, rtn[tower], batch), 5, 2)
            model_ms = cuda_ms(lambda: encode(batch), 5, 2)
            unit = "img/s" if tower == "vision" else "txt/s"
            rates[tower] = {"int8_ms": ms, "bf16_ms": model_ms, "cosine_rtn":
                            cosines["round-to-nearest"], "cosine_kernel":
                            cosines["quantizer kernel"]}
            log(f"[9 int8] {tower}_encode_int8 batch {MAX_BATCH} vs the bf16 model on the same "
                f"fp32 weights: lowest cosine of a row {cosines['round-to-nearest']:.5f} with "
                f"round-to-nearest weights, {cosines['quantizer kernel']:.5f} with the quantizer "
                f"kernel's (min {INT8_COSINE_MIN}); {TOWER_LAYERS} attention launches an encode; "
                f"{ms:.2f} ms = {MAX_BATCH / ms * 1e3:.1f} {unit}, the bf16 model {model_ms:.2f} "
                f"ms = {MAX_BATCH / model_ms * 1e3:.1f} {unit} on a batch already on the card "
                f"(phase 5, from a host batch: {encode_ms[tower]:.2f} ms) ({card})")
            if min(cosines.values()) <= INT8_COSINE_MIN:
                raise RuntimeError(f"{tower} int8 encode: cosine {cosines} <= {INT8_COSINE_MIN}")
        raw = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (MAX_BATCH, size, size, 3), dtype=np.uint8)).to(dev)
        got = vision_encode_int8(cfg, rtn["vision"], raw)
        if not (torch.isfinite(got).all() and (got.norm(dim=-1) - 1).abs().max() < 1e-4):
            raise RuntimeError("vision_encode_int8 on a uint8 batch: not finite unit-norm rows")
        log(f"[9 int8] vision_encode_int8 on a uint8 batch of {MAX_BATCH}: finite unit-norm rows")

        # (c) the int8 MaxSim forward on the model's token features
        tok_i = model.encode_image(images, normalize=True)[1].contiguous()
        tok_t = model.encode_text(texts, normalize=True)[1].contiguous()
        zero_rows = tok_t.float().abs().amax(dim=-1) == 0               # at and after EOT
        qt, _ = maxsim.quant_tokens_int8(tok_t)
        if not (zero_rows.any() and (qt[zero_rows] == 0).all()):
            raise RuntimeError("zero text rows do not quantize to exact zeros")
        int8_err = {}
        for n in (MAX_BATCH, TRAIN_BATCH):
            t, i = tok_t[:n].contiguous(), tok_i[:n].contiguous()
            maxsim.LAUNCHES.reset()
            got = maxsim.maxsim(t, i, impl="streaming_int8")
            launched = maxsim.LAUNCHES.value
            want = maxsim.maxsim(t, i)
            # a zero row scores exactly 0, so 'nonzero' leaves out what a mask
            # over the non-zero rows leaves out. It also leaves out a live token
            # whose largest int32 sum over an image's tokens is exactly 0, which
            # an integer sum can be (a few scores in 1e5 at a random init): those
            # scores differ, by one token in the mean. Were zero rows counted,
            # every score would differ.
            masked = maxsim.maxsim(t, i, mask_mode="valid", impl="streaming_int8",
                                   text_mask=(~zero_rows[:n]).float())
            torch.cuda.synchronize()
            int8_err[n] = (got - want).abs().max().item()
            dropped = ((got - masked).abs() > 1e-6).float().mean().item()
            log(f"[9 int8] maxsim(impl='streaming_int8') {n} x {n} on the model's bf16 token "
                f"features vs the default forward: max_abs_err {int8_err[n]:.3g} (tol "
                f"{INT8_MAXSIM_TOL}); 'nonzero' vs a mask over the non-zero rows: "
                f"{dropped:.2e} of the scores differ (limit 1e-3: live tokens whose largest "
                f"integer sum is 0); forward-kernel launches {launched}")
            if not (0 < int8_err[n] <= INT8_MAXSIM_TOL and dropped <= 1e-3 and launched == 0):
                raise RuntimeError(f"int8 maxsim {n} x {n}: {int8_err[n]} > {INT8_MAXSIM_TOL}, "
                                   "or zero rows were counted")
        int8_ms = cuda_ms(lambda: maxsim.maxsim(tok_t, tok_i, impl="streaming_int8"), 3, 1)
        kernel_ms = cuda_ms(lambda: maxsim.maxsim(tok_t, tok_i), 3, 1)
        log(f"[9 int8] maxsim forward {TRAIN_BATCH} x {TRAIN_BATCH} bf16: int8 (library "
            f"products) {int8_ms:.3f} ms, the forward kernel {kernel_ms:.3f} ms ({card})")

    # its backward is the default backward on the same inputs, which adds in one
    # fixed order (no float atomics): dT and dI equal bit for bit
    g = torch.randn(MAX_BATCH, MAX_BATCH, generator=torch.Generator().manual_seed(9)).to(dev)
    grads = []
    for impl in ("streaming_int8", "auto"):
        t = tok_t[:MAX_BATCH].float().clone().requires_grad_()
        i = tok_i[:MAX_BATCH].float().clone().requires_grad_()
        maxsim.BWD_LAUNCHES.reset()
        grads.append(torch.autograd.grad(maxsim.maxsim(t, i, impl=impl), (t, i), g))
        if maxsim.BWD_LAUNCHES.value != 1:
            raise RuntimeError(f"maxsim impl={impl!r}: the backward kernel was not launched")
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    log(f"[9 int8] maxsim(impl='streaming_int8') backward vs the default backward, same fp32 "
        f"inputs and cotangent: dT and dI {'equal bit for bit' if same else 'NOT equal'}")
    if not same:
        raise RuntimeError("the int8 MaxSim's backward is not the default backward")
    del tok_i, tok_t, grads, g

    # one colclip train step at batch 256 with the int8 forward, learning rate
    # 0 (AdamW then changes nothing), against the default step on the same weights
    model.train()
    zero = const_lr(0.0, 0)
    losses, step_ms = {}, {}
    for impl in ("streaming_int8", "auto"):
        step = make_train_step(model, create_optimizer(model, zero), zero, TrainStepConfig(
            loss_type="colclip", alpha=0.5, mask_mode="nonzero", maxsim_impl=impl))
        for c in (maxsim.LAUNCHES, maxsim.BWD_LAUNCHES):
            c.reset()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = step(images, texts)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        losses[impl] = {k: float(v) for k, v in metrics.items()}
        step_ms[impl] = min(secs[1:]) * 1e3
        want = (0, 3) if impl == "streaming_int8" else (3, 3)
        if (maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value) != want:
            raise RuntimeError(f"maxsim_impl={impl!r}: MaxSim launches "
                               f"{(maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value)} != {want}")
        del step
    loss_err = abs(losses["streaming_int8"]["total_loss"] - losses["auto"]["total_loss"])
    log(f"[9 int8] colclip step at batch {TRAIN_BATCH}, maxsim_impl='streaming_int8' vs the "
        f"default: total_loss {losses['streaming_int8']['total_loss']:.5f} / "
        f"{losses['auto']['total_loss']:.5f} (|difference| {loss_err:.3g}, tol "
        f"{INT8_STEP_LOSS_TOL}); step {step_ms['streaming_int8']:.2f} / {step_ms['auto']:.2f} ms "
        f"(the faster of steps 1-2; phase 6: {train['step_ms']:.2f} ms) ({card})")
    if not (all(math.isfinite(v) for v in losses["streaming_int8"].values())
            and loss_err <= INT8_STEP_LOSS_TOL):
        raise RuntimeError(f"the int8 step's loss is {loss_err} from the default step's")
    model.eval()
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()

    # (d) /v1/search over HTTP on an index built through the same model
    corpus = np.random.default_rng(2).integers(0, 256, (INDEX_ITEMS, size, size, 3),
                                               dtype=np.uint8)
    queries = ["a photo of a cat sleeping on a red sofa",
               "two dogs running on the beach at sunset", "a bowl of ramen with an egg"]
    with tempfile.TemporaryDirectory() as index_dir:
        t0 = time.perf_counter()
        build_image_index(model, iter(corpus), index_dir, device=dev, batch_size=INDEX_BATCH,
                          ids=[f"img{i:04d}" for i in range(INDEX_ITEMS)], model_name=MODEL)
        build_s = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(index_dir, f)) for f in os.listdir(index_dir))
        del corpus
        svc = ColXLIPService(MODEL, device=dev, max_batch=MAX_BATCH, model=model, cfg=cfg,
                             index_dir=index_dir)
        httpd = make_server(svc, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        log(f"[9 int8] index of {INDEX_ITEMS} seeded uint8 images built in {build_s:.2f} s = "
            f"{INDEX_ITEMS / build_s:.1f} img/s (batches of {INDEX_BATCH}; {on_disk / 2**20:.0f} "
            f"MiB on disk); serving it on port {port} ({card})")
        try:
            health = http(port, "/healthz")[0]
            if health["index_items"] != INDEX_ITEMS:
                raise RuntimeError(f"/healthz: {health}")
            bodies = [{"texts": queries, "k": SEARCH_K, "shortlist": SEARCH_SHORTLIST,
                       "scoring": scoring} for scoring in ("global", "maxsim", "mixed")]
            bodies.append({"texts": queries, "k": SEARCH_K, "shortlist": INDEX_ITEMS,
                           "scoring": "maxsim"})
            for c in (attention.LAUNCHES, maxsim.LAUNCHES):
                c.reset()
            answers = [http(port, "/v1/search", body) for body in bodies]
            torch.cuda.synchronize()
            search_launches = {"fused_attention_fwd": attention.LAUNCHES.value,
                               "maxsim_fwd": maxsim.LAUNCHES.value}
            # one text wave through the tower's layers a request; one MaxSim launch a query of
            # the three reranking requests
            if search_launches != {"fused_attention_fwd": TOWER_LAYERS * len(bodies),
                                   "maxsim_fwd": 9}:
                raise RuntimeError(f"/v1/search launches {search_launches}")

            # the recomputation: the same text features, stage 1 on the host,
            # score_similarity on the shortlist's stored features
            index = RetrievalIndex(index_dir, device=dev)
            with torch.inference_mode():
                txt_pooled, txt_tokens = svc.engine.run("text", svc.tokenize(queries))
                all_pooled = torch.from_numpy(np.asarray(index.pooled, np.float32)).to(dev)
                all_tokens = torch.from_numpy(np.asarray(index.tokens, np.float32)).to(dev)
                stage1 = svc.logit_scale * (txt_pooled.float() @ all_pooled.T)        # [3, N]
                search_err = 0.0
                for body, (resp, _) in zip(bodies, answers):
                    idx = np.asarray(resp["indices"])
                    scores = np.asarray(resp["scores"], np.float32)
                    if idx.shape != (3, SEARCH_K) or not np.isfinite(scores).all() or \
                            resp["ids"] != [[f"img{i:04d}" for i in row] for row in idx]:
                        raise RuntimeError(f"/v1/search {body['scoring']}: malformed answer")
                    for m in range(len(queries)):
                        short = stage1[m].topk(body["shortlist"]).indices
                        if body["scoring"] == "global":
                            short = torch.arange(INDEX_ITEMS, device=dev)
                        sim = score_similarity(
                            all_pooled[short], txt_pooled[m:m + 1], all_tokens[short],
                            txt_tokens[m:m + 1].float(), svc.logit_scale,
                            scoring=body["scoring"], alpha=svc.alpha)[:, 0]      # [shortlist]
                        top = sim.topk(SEARCH_K)
                        want_idx = short[top.indices].cpu().numpy()
                        err = float(np.abs(scores[m] - top.values.cpu().numpy()).max())
                        search_err = max(search_err, err)
                        # the same items, but for ties closer than the fp32 sums resolve
                        if not (set(idx[m]) == set(want_idx) or err <= 1e-4):
                            raise RuntimeError(f"/v1/search {body['scoring']} shortlist "
                                               f"{body['shortlist']} query {m}: items {idx[m]} "
                                               f"!= {want_idx}")
                    what = ("brute force over all items" if body["shortlist"] == INDEX_ITEMS
                            else "score_similarity on the stage-1 shortlist")
                    log(f"[9 int8] /v1/search {body['scoring']} k {SEARCH_K} shortlist "
                        f"{body['shortlist']}: the items of {what}; scores max_abs_err so far "
                        f"{search_err:.3g}")
                tol = SCORE_TOL_PER_UNIT_SCALE * svc.logit_scale
                if not search_err <= tol:
                    raise RuntimeError(f"/v1/search scores: {search_err} > {tol}")
                del all_pooled, all_tokens
            lat = {}
            for body in bodies:
                key = f"{body['scoring']} shortlist {body['shortlist']}"
                reps = 5 if body["shortlist"] == SEARCH_SHORTLIST else 2
                lat[key] = statistics.median(http(port, "/v1/search", body)[1]
                                             for _ in range(reps)) * 1e3
            log(f"[9 int8] /v1/search 3 texts, k {SEARCH_K}: "
                + ", ".join(f"{k} median {v:.1f} ms" for k, v in lat.items())
                + f"; scores vs the recomputation max_abs_err {search_err:.3g} (tol {tol:.3g}); "
                f"kernel launches of the four checked requests {search_launches} ({card})")
        finally:
            httpd.shutdown()
            svc.stop()
            server.join(timeout=30)
    del model
    torch.cuda.empty_cache()
    return {"quant_launches": sum(quant_launches.values()), "requant_ms": requant_ms,
            "encode": rates,
            "maxsim_int8_err": int8_err[TRAIN_BATCH], "maxsim_int8_ms": int8_ms,
            "maxsim_kernel_ms": kernel_ms, "step_ms": step_ms, "loss_err": loss_err,
            "index_img_per_s": INDEX_ITEMS / build_s, "search_ms": lat,
            "search_err": search_err, "search_launches": search_launches}


def seeded_jpeg(rng, path: str) -> None:
    """A JPEG with sides drawn from EVAL_IMAGE_SIDES and low-frequency
    content, so that it decodes like a photo of that size."""
    from PIL import Image

    h, w = (int(x) for x in rng.integers(EVAL_IMAGE_SIDES[0], EVAL_IMAGE_SIDES[1] + 1, 2))
    coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype="uint8")
    Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(path, quality=90)


def write_flickr_suite(root: str, seed: int = 0):
    """The vendored Flickr30k val annotations under ``root`` with one seeded
    JPEG at each image path they name. Returns (the reader's root_dir,
    texts, images)."""
    import shutil

    import numpy as np

    with open(FLICKR_ANNOTATIONS) as f:
        anns = json.load(f)
    img_dir = os.path.join(root, "flickr30k-images")
    os.makedirs(img_dir)
    shutil.copy(FLICKR_ANNOTATIONS, img_dir)
    rng = np.random.default_rng(seed)
    for ann in anns:
        seeded_jpeg(rng, os.path.join(root, ann["image"]))
    return img_dir, sum(len(a["caption"]) for a in anns), len({a["image"] for a in anns})


def write_imagenet_folder(root: str, classes: int, seed: int = 1) -> None:
    """A torchvision-layout folder: one seeded JPEG in each of ``classes``
    sorted class directories (no classnames.json: the vendored names)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:08d}"))
        seeded_jpeg(rng, os.path.join(root, f"n{c:08d}", "0.JPEG"))


def encode_launches(n_texts: int, n_images: int, batch: int) -> int:
    """Attention forward launches of one eval: one a block an encode batch."""
    return TOWER_LAYERS * (-(-n_texts // batch) + -(-n_images // batch))


def loop_retrieval_metrics(i2t_sim, txt2img, img2txt) -> dict:
    """The reference's per-row loops (numpy's stable argsort of -sim, the
    rank of the first ground truth): the oracle the metrics must equal."""
    import numpy as np

    out = {}
    t2i_ranks = np.array([np.where(np.argsort(-row, kind="stable") == txt2img[i])[0][0]
                          for i, row in enumerate(i2t_sim.T)], np.float64)
    i2t_ranks = np.array([min(np.where(np.argsort(-row, kind="stable") == c)[0][0]
                              for c in img2txt[i]) for i, row in enumerate(i2t_sim)], np.float64)
    for pre, r in (("text_to_image", t2i_ranks), ("image_to_text", i2t_ranks)):
        out.update({f"{pre}_R@1": float((r < 1).mean()), f"{pre}_R@5": float((r < 5).mean()),
                    f"{pre}_R@10": float((r < 10).mean()),
                    f"{pre}_mean_rank": float(r.mean() + 1),
                    f"{pre}_median_rank": float(np.floor(np.median(r)) + 1)})
    return out


def r_at_k(metrics: dict, prefix: str = "") -> str:
    return ", ".join(f"{d} R@{k} {metrics[f'{prefix}{d}_R@{k}']:.4f}"
                     for d in ("text_to_image", "image_to_text") for k in (1, 5, 10))


class _Records(logging.Handler):
    """Keeps the messages of the loggers it is added to."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def check_zero_shot(model, tokenizer, classnames, clf, batches, zs: dict, card: str) -> dict:
    """The zero-shot classifier and the logits of its images, kernels against
    the plain versions on the same weights and inputs: the classifier within
    ENCODE_TOL on any element and ENCODE_COSINE_TOL on 1 - cosine of any
    class, the logits within ZS_LOGIT_TOL; ``zs``'s top-1 / top-5 must be
    those of the kernels' logits."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.training import zero_shot

    t0 = time.perf_counter()
    with plain_versions():
        plain_clf = zero_shot.build_zero_shot_classifier(model, tokenizer, classnames)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    clf_err = (clf - plain_clf).abs().max().item()
    clf_off = (1.0 - torch.nn.functional.cosine_similarity(clf, plain_clf, dim=0)).max().item()
    dev = clf.device
    logits = []
    for plain in (False, True):
        with plain_versions() if plain else contextlib.nullcontext(), torch.inference_mode():
            feats = torch.cat([zero_shot._pooled(model.encode_image(
                torch.from_numpy(images).to(dev), normalize=True)) for images, _ in batches])
        logits.append((feats @ (plain_clf if plain else clf)).cpu().numpy())
    labels = np.concatenate([lab for _, lab in batches])
    logit_err = float(np.abs(logits[0] - logits[1]).max())
    acc = []
    for lg in logits:
        top = np.argsort(-lg, axis=1)[:, :5]
        acc.append({"imagenet-zeroshot-val-top1": float((top[:, 0] == labels).mean()),
                    "imagenet-zeroshot-val-top5": float((top == labels[:, None]).any(1).mean())})
    same_top1 = float((logits[0].argmax(1) == logits[1].argmax(1)).mean())
    log(f"[10 eval] zero-shot vs the plain versions: classifier {tuple(clf.shape)} max_abs_err "
        f"{clf_err:.3g} (tol {ENCODE_TOL}), largest 1 - cosine of a class {clf_off:.3g} (tol "
        f"{ENCODE_COSINE_TOL}); logits of {len(labels)} images max_abs_err {logit_err:.3g} "
        f"(tol {ZS_LOGIT_TOL:.3g}); top-1 class the same for {same_top1:.1%} of the images; "
        f"kernels {acc[0]}, plain {acc[1]}; plain classifier {plain_s:.2f} s ({card})")
    if not (clf_err <= ENCODE_TOL and clf_off <= ENCODE_COSINE_TOL
            and logit_err <= ZS_LOGIT_TOL and acc[0] == zs):
        raise RuntimeError(f"zero-shot vs the plain versions: classifier {clf_err} / {clf_off}, "
                           f"logits {logit_err}, top-k {zs} (kernels' logits give {acc[0]})")
    return {"classifier_err": clf_err, "classifier_cosine_off": clf_off,
            "logit_err": logit_err, "plain": acc[1], "same_top1": same_top1}


def eval_phase(dev, card: str, flickr_root: str, n_texts: int, n_images: int, work: str):
    """Phase 10: retrieval and zero-shot eval of ViT-B-16-colxlip (full
    width and depth, seed 0) through the entry point's eval-only mode."""
    import numpy as np
    import torch

    from colxlip_tpu_torch import factory
    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.data.retrieval import build_retrieval_suite
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.training import evaluate, zero_shot
    from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    model, _ = factory.create_model(EVAL_MODEL, dev, torch.bfloat16, seed=0)
    pt = save_pt_checkpoint(os.path.join(work, "eval.pt"), model)
    del model
    torch.cuda.empty_cache()
    logs = os.path.join(work, "logs")
    argv = ["--model", EVAL_MODEL, "--pretrained", pt, "--allow-degraded-tokenizer",
            "--precision", "bf16", "--batch-size", str(EVAL_BATCH), "--logs", logs,
            "--name", "eval", "--retrieval-flickr", "--flickr-data-root-dir", flickr_root,
            "--eval-scoring", "mixed", "--alpha", str(EVAL_ALPHA), "--seed", "0"]
    log(f"[10 eval] python -m colxlip_tpu_torch.main {' '.join(argv)}")
    counters = {"fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES,
                "maxsim_fwd": maxsim.LAUNCHES, "maxsim_bwd": maxsim.BWD_LAUNCHES}
    unused = fused_counters()
    captured = []
    real_metrics = evaluate.compute_retrieval_metrics

    def capture(sim, txt2img, img2txt):
        captured.append((np.array(sim), txt2img, img2txt))
        return real_metrics(sim, txt2img, img2txt)

    evaluate.compute_retrieval_metrics = capture
    for c in (*counters.values(), *unused.values()):
        c.reset()
    t0 = time.perf_counter()
    try:
        rc = entry.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in counters.items()}
    finally:
        evaluate.compute_retrieval_metrics = real_metrics
        setup_logging(None)
    if rc != 0 or len(captured) != 1:
        raise RuntimeError(f"eval-only main returned {rc} after {len(captured)} suites")
    check_default_path(unused, "phase 10")
    want = {"fused_attention_fwd": encode_launches(n_texts, n_images, EVAL_BATCH),
            "fused_attention_bwd": 0, "maxsim_fwd": 1, "maxsim_bwd": 0}
    log(f"[10 eval] rc 0 in {wall:.1f} s; kernel launches {launches} (expected {want})")
    if launches != want:
        raise RuntimeError(f"phase 10 launches {launches}, expected {want}")
    sim, txt2img, img2txt = captured[0]
    if sim.shape != (n_images, n_texts) or sim.dtype != np.float32 or not np.isfinite(sim).all():
        raise RuntimeError(f"similarity {sim.dtype} {sim.shape}, not finite [{n_images}, "
                           f"{n_texts}] float32")
    with open(os.path.join(logs, "eval", "checkpoints", "results.jsonl")) as f:
        (results,) = [json.loads(line) for line in f]
    oracle = loop_retrieval_metrics(sim, txt2img, img2txt)
    got = {k[len("flickr_"):]: v for k, v in results.items() if k.startswith("flickr_")
           and not k.endswith("_samples")}
    if got != oracle or results["epoch"] != 0 or results["flickr_num_text_samples"] != n_texts:
        raise RuntimeError(f"results.jsonl {results} against the loop oracle {oracle}")
    with open(os.path.join(logs, "eval", "out.log")) as f:
        split = re.findall(r"flickr seconds: (.*)", f.read())
    log(f"[10 eval] Flickr30k val {n_texts} texts x {n_images} images, mixed scoring "
        f"(alpha {EVAL_ALPHA}), batch {EVAL_BATCH}: wall {wall:.2f} s (model build and "
        f".pt load included); {split[-1]}; metrics equal the loop oracle; {r_at_k(oracle)} "
        f"({card})")

    # the same weights, inputs and device through the plain versions
    model, _, _, preprocess_val = factory.create_model_and_transforms(
        EVAL_MODEL, pt, device=dev, precision="bf16")
    tokenizer = factory.get_tokenizer(EVAL_MODEL)
    suite = build_retrieval_suite("flickr", {"root_dir": flickr_root, "split": "val"},
                                  tokenizer, preprocess_val)
    scale = float(np.exp(model.logit_scale.detach().cpu().numpy()))
    with plain_versions():
        enc = evaluate.Encoder(model, EVAL_BATCH)
        txt_feats, txt_tokens = enc.encode_texts(suite)
        img_feats, img_tokens = enc.encode_images(suite)
        plain_sim = evaluate.score_similarity(img_feats, txt_feats, img_tokens, txt_tokens,
                                              scale, scoring="mixed", alpha=EVAL_ALPHA)
    plain_sim = plain_sim.cpu().numpy()
    sim_err = float(np.abs(sim - plain_sim).max())
    sim_tol = SCORE_TOL_PER_UNIT_SCALE * scale
    plain_metrics = evaluate.compute_retrieval_metrics(plain_sim, suite.txt2img, suite.img2txt)
    log(f"[10 eval] similarity vs the plain path: max_abs_err {sim_err:.3g} (tol "
        f"{sim_tol:.3g} = {SCORE_TOL_PER_UNIT_SCALE} x logit_scale {scale:.4f}); |score| max "
        f"{np.abs(plain_sim).max():.3g}; plain path {r_at_k(plain_metrics)} (chance: R@1 "
        f"{1 / n_images:.4f} text to image)")
    if not sim_err <= sim_tol:
        raise RuntimeError(f"phase 10 similarity: {sim_err} > {sim_tol}")

    # kernel #5 in fp32 at the eval shape on the eval's tokens, against its
    # plain version (MAXSIM_TOL), then timed beside it and its bound
    with torch.inference_mode():
        got = maxsim.maxsim(txt_tokens, img_tokens)
        want = maxsim.maxsim_plain(txt_tokens, img_tokens)
        maxsim_err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        del got, want
        ms = cuda_ms(lambda: maxsim.maxsim(txt_tokens, img_tokens), 1, warmup=0)
        plain_ms = cuda_ms(lambda: maxsim.maxsim_plain(txt_tokens, img_tokens), 1, warmup=0)
    bound = maxsim_bound(txt_tokens, img_tokens, False)
    shape = (*txt_tokens.shape, *img_tokens.shape[:2])
    log(f"[10 eval] maxsim_fwd fp32 at the eval shape M={shape[0]} Lt={shape[1]} D={shape[2]} "
        f"K={shape[3]} Li={shape[4]} vs its plain version on the eval's tokens: max_abs_err "
        f"{maxsim_err:.3g} (tol {MAXSIM_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound[0]:.5f} ms by {bound[1]} ({bound[0] / ms:.1%} of it) ({card})")
    if not (maxsim_err <= MAXSIM_TOL and finite):
        raise RuntimeError(f"phase 10 maxsim at the eval shape: {maxsim_err} > {MAXSIM_TOL}")
    del txt_tokens, img_tokens, txt_feats, img_feats

    # kernel #1's share of an encode batch's device time (torch.profiler)
    model.eval()
    batches = {"image": torch.from_numpy(next(suite.iter_image_batches(EVAL_BATCH))).to(dev),
               "text": torch.from_numpy(suite.tokens[:EVAL_BATCH]).to(dev)}
    share = {}
    with torch.no_grad():
        for kind, batch in batches.items():
            fn = getattr(model, f"encode_{kind}")
            fn(batch)
            by = device_ms_by_kernel(lambda: fn(batch, normalize=True), 3, r"^(.*)$")
            attn_ms = sum(v for k, v in by.items() if "attn_fwd" in k)
            share[kind] = {"attention_ms": attn_ms, "device_ms": sum(by.values())}
            log(f"[10 eval] encode {kind} batch {EVAL_BATCH}: device {share[kind]['device_ms']:.3f} "
                f"ms, of which the attention kernel {attn_ms:.3f} ms "
                f"({attn_ms / share[kind]['device_ms']:.1%}) ({card})")

    # zero-shot: the full 1,000 x 80 classifier, one image a class
    val = os.path.join(work, "imagenet")
    write_imagenet_folder(val, ZS_CLASSES)
    records = _Records()
    zs_logger = logging.getLogger(zero_shot.__name__)
    zs_logger.addHandler(records)
    zs_logger.setLevel(logging.INFO)
    clf, seen = [], []
    real_build, real_iter = zero_shot.build_zero_shot_classifier, zero_shot.iter_imagenet_val
    zero_shot.build_zero_shot_classifier = lambda *a, **k: clf.append(real_build(*a, **k)) or clf[-1]

    def keep_batches(*a, **k):
        for item in real_iter(*a, **k):
            seen.append(item)
            yield item

    zero_shot.iter_imagenet_val = keep_batches
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        zs = zero_shot.zero_shot_eval(model, tokenizer, preprocess_val, val,
                                      batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
    finally:
        zero_shot.build_zero_shot_classifier = real_build
        zero_shot.iter_imagenet_val = real_iter
        zs_logger.removeHandler(records)
    zs_wall = time.perf_counter() - t0
    zs_launches = {name: c.value for name, c in counters.items()}
    n_names = len(zero_shot.resolve_classnames(val))
    zs_want = {"fused_attention_fwd": TOWER_LAYERS * (-(-n_names // ZS_BATCH_CLASSES)
                                                     + -(-ZS_CLASSES // EVAL_BATCH)),
               "fused_attention_bwd": 0, "maxsim_fwd": 0, "maxsim_bwd": 0}
    norms = clf[0].norm(dim=0) if clf else None
    if (zs_launches != zs_want or set(zs) != {"imagenet-zeroshot-val-top1",
                                              "imagenet-zeroshot-val-top5"}
            or not 0 <= zs["imagenet-zeroshot-val-top1"] <= zs["imagenet-zeroshot-val-top5"] <= 1
            or clf[0].shape != (model.cfg.embed_dim, n_names)
            or not torch.isfinite(clf[0]).all()
            or (norms - 1).abs().max() > 1e-3):
        raise RuntimeError(f"zero-shot: {zs}, launches {zs_launches} (expected {zs_want}), "
                           f"classifier {tuple(clf[0].shape) if clf else None}")
    zs_split = [m for m in records.messages if m.startswith("zero-shot seconds")]
    log(f"[10 eval] zero-shot, {n_names} classes x 80 templates, {ZS_CLASSES} images: "
        f"{zs}; {zs_wall:.2f} s ({zs_split[-1]}); launches {zs_launches} ({card})")
    zs_check = check_zero_shot(model, tokenizer, zero_shot.resolve_classnames(val), clf[0],
                               seen, zs, card)
    del model
    torch.cuda.empty_cache()
    return {"suite": "flickr", "texts": n_texts, "images": n_images, "scoring": "mixed",
            "wall_s": wall, "split": split[-1], "launches": launches, "sim_err": sim_err,
            "sim_tol": sim_tol, "metrics": oracle, "plain_metrics": plain_metrics,
            "maxsim_fp32": {"m": shape[0], "lt": shape[1], "d": shape[2], "k": shape[3],
                            "li": shape[4], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                            "bound_by": bound[1], "launches": launches["maxsim_fwd"],
                            "max_abs_err": maxsim_err},
            "encode_attention_share": share,
            "zero_shot": {**zs, "seconds": zs_wall, "split": zs_split[-1],
                          "launches": zs_launches, **zs_check}}


def feed_bytes(images, texts, packed: bool) -> int:
    """Host-to-device bytes of one batch as the ship stage sends it: the
    packed buffer, or the images and the caption-0 ids (int32)."""
    import numpy as np

    from colxlip_tpu_torch.parallel.data_feed import pack_batch
    from colxlip_tpu_torch.training.train import select_caption0

    texts = select_caption0(texts)
    if packed:
        return pack_batch(images, texts).nbytes
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    return images.nbytes + texts.nbytes


def host_pipeline(spec: str, flags, workers: int, batches: int):
    """The tar pipeline alone (no model, no device), built as main builds it
    for ``flags``: (img/s over ``batches`` batches after the first, the
    first batch)."""
    from colxlip_tpu_torch.data.transforms import image_transform
    from colxlip_tpu_torch.data.wds import WdsConfig, WdsTrainPipeline
    from colxlip_tpu_torch.factory import get_tokenizer
    from colxlip_tpu_torch.models import get_model_config

    size = get_model_config(TAR_MODEL)["vision_cfg"]["image_size"]
    transform = image_transform(size, True, normalize_on_device="--normalize-on-device" in flags,
                                ship="yuv420" if "yuv420" in flags else "rgb")
    pipe = WdsTrainPipeline(
        WdsConfig(urls=spec, batch_size=TRAIN_BATCH, seed=0, num_workers=workers,
                  num_sampled_captions=1, native_decode="--native-decode" in flags),
        transform, get_tokenizer(TAR_MODEL))
    it = iter(pipe)
    try:
        first = next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        secs = time.perf_counter() - t0
    finally:
        it.close()
    return batches * TRAIN_BATCH / secs, first


def tar_phase(dev, card: str, phase6_first_loss: float):
    """Phase 11: ViT-B-16-colxlip trained by main from seeded tar shards in
    three feeds, with the host pipeline alone beside each run."""
    import numpy as np
    import torch

    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch import native
    from colxlip_tpu_torch.data import shard_writer
    from colxlip_tpu_torch.data.transforms import (OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                                                   image_transform, sample_rrc_box)
    from colxlip_tpu_torch.models import get_model_config
    from colxlip_tpu_torch.ops import attention, fused_ce, maxsim, yuv420
    from colxlip_tpu_torch.parallel.data_feed import DeviceFeeder, unpack_batch
    from colxlip_tpu_torch.training.logging_utils import setup_logging
    from colxlip_tpu_torch.training.train import select_caption0

    cfg = get_model_config(TAR_MODEL)
    size = cfg["vision_cfg"]["image_size"]
    layers = cfg["vision_cfg"]["layers"] + cfg["text_cfg"]["layers"]   # one attention each
    workers = min(8, os.cpu_count() or 1)
    has_jpeg = native.libjpeg_present()
    log(f"[11 tar] native decoder probe (a program with jpeglib.h linked with -ljpeg by "
        f"{native.CXX}): {'builds' if has_jpeg else 'does not build'} on this machine -> run "
        f"(b) {'with' if has_jpeg else 'WITHOUT'} --native-decode")
    runs = [("a", [], 2),
            ("b", [*(["--native-decode"] if has_jpeg else []), "--normalize-on-device",
                   "--packed-feed"], 2),
            ("c", ["--ship-format", "yuv420", "--packed-feed"], 1)]
    counters = {"fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES,
                "maxsim_fwd": maxsim.LAUNCHES, "maxsim_bwd": maxsim.BWD_LAUNCHES}
    idle_counters = {**fused_counters(), "fused_ce_fwd": fused_ce.FWD_LAUNCHES,
                     "fused_ce_bwd_da": fused_ce.BWD_DA_LAUNCHES,
                     "fused_ce_bwd_db": fused_ce.BWD_DB_LAUNCHES}
    out = {"workers": workers, "cpu_count": os.cpu_count(), "native_decode": has_jpeg,
           "runs": {}}
    with tempfile.TemporaryDirectory() as work:
        shard_dir = os.path.join(work, "shards")
        paths, secs, shard_bytes = shard_writer.write_shards(
            shard_dir, TAR_SHARDS, TAR_PER_SHARD, seed=0, workers=workers)
        spec = os.path.join(shard_dir, "{0000..%04d}.tar" % (TAR_SHARDS - 1))
        log(f"[11 tar] wrote {TAR_SHARDS} shards x {TAR_PER_SHARD} samples (jpg 512 x 512-768 "
            f"at quality 95 + recaption json) in {secs:.1f} s, {shard_bytes / 1e6:.1f} MB, "
            f"{workers} threads")
        out["shards"] = {"seconds": secs, "mb": shard_bytes / 1e6}
        for name, flags, epochs in runs:
            steps = epochs * TAR_STEPS_PER_EPOCH
            img_per_s, (images, texts) = host_pipeline(spec, flags, workers, TAR_HOST_BATCHES)
            packed = "--packed-feed" in flags
            h2d = feed_bytes(images, texts, packed)
            if name == "b":
                # a host batch through the packed feed and unpacked on the card
                caption0 = select_caption0(texts)
                buf, _ = DeviceFeeder(dev, packed=True)(images, caption0)
                got_i, got_t = unpack_batch(buf, images.shape[1:], caption0.shape[1])
                torch.cuda.synchronize()
                if not (np.array_equal(got_i.cpu().numpy(), images)
                        and np.array_equal(got_t.cpu().numpy(), caption0)):
                    raise RuntimeError("(b): the batch unpacked on the card is not the host's")
                log("[11 tar] (b) a host batch packed, copied and unpacked on the card equals "
                    "the host batch bit for bit")
            if name == "c":
                dec = yuv420.decode_yuv420(torch.from_numpy(images).to(dev),
                                           OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
                ref = (yuv420.yuv420_to_rgb(images) / 255.0
                       - np.asarray(OPENAI_DATASET_MEAN, np.float32)) / np.asarray(
                           OPENAI_DATASET_STD, np.float32)
                err = float(np.abs(dec.cpu().numpy() - ref).max())
                log(f"[11 tar] (c) decode_yuv420 on the card, batch {images.shape[0]}: "
                    f"max_abs_err {err:.3g} against the numpy yuv420_to_rgb (tol {YUV_TOL})")
                if not err <= YUV_TOL:
                    raise RuntimeError(f"(c): decode_yuv420 {err} > {YUV_TOL}")
                out["yuv_decode_err"] = err
            logs = os.path.join(work, f"logs-{name}")
            argv = ["--model", TAR_MODEL, "--train-data", spec, "--batch-size", str(TRAIN_BATCH),
                    "--precision", "bf16", "--workers", str(workers), "--seed", "0",
                    "--epochs", str(epochs), "--steps-per-epoch", str(TAR_STEPS_PER_EPOCH),
                    "--log-every-n-steps", "1", "--save-frequency", "0", "--logs", logs,
                    "--name", name, "--profile-dir", os.path.join(logs, "trace"), *flags]
            log(f"[11 tar] ({name}) python -m colxlip_tpu_torch.main {' '.join(argv)}")
            for c in (*counters.values(), *idle_counters.values()):
                c.reset()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                rc = entry.main(argv)
                torch.cuda.synchronize()
            finally:
                setup_logging(None)
            secs = time.perf_counter() - t0
            launches = {k: c.value for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            base = os.path.join(logs, name)
            with open(os.path.join(base, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            with open(os.path.join(base, "out.log")) as f:
                out_log = f.read()
            idle = re.findall(r"profiled steps: .*device idle ([0-9.]+)%", out_log)
            epoch_s = [float(x) for x in re.findall(r"Epoch \d+ done: \d+ steps in ([0-9.]+)s",
                                                    out_log)]
            losses = [r["total_loss"] for r in recs]
            if rc != 0 or len(recs) != steps or not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"({name}): rc {rc}, losses {losses}")
            if abs(losses[0] - phase6_first_loss) > 0.5:
                raise RuntimeError(f"({name}): first loss {losses[0]} is not within 0.5 of "
                                   f"phase 6's {phase6_first_loss}")
            want = {"fused_attention_fwd": layers * steps, "fused_attention_bwd": layers * steps,
                    "maxsim_fwd": steps, "maxsim_bwd": steps}
            if launches != want:
                raise RuntimeError(f"({name}): launches {launches}, expected {want}")
            check_default_path(idle_counters, f"phase 11 ({name})")
            if not idle:
                raise RuntimeError(f"({name}): the profiled steps logged no device time")
            steady = recs[2:]
            step_ms = statistics.median(r["batch_time"] for r in steady) * 1e3
            data_ms = statistics.median(r["data_time"] for r in steady) * 1e3
            log(f"[11 tar] ({name}) {' '.join(flags) or 'PIL decode, float32 feed'}: rc 0 in "
                f"{secs:.1f} s, {steps} steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}; step "
                f"median {step_ms:.2f} ms = {TRAIN_BATCH / step_ms * 1e3:.1f} samples/s over "
                f"steps 3..{steps} (steps 3-5 profiled); data_time median {data_ms:.2f} ms; "
                f"device idle {idle[-1]}% over steps 3-5; host->device {h2d / 1e6:.2f} MB a "
                f"step; peak device memory {peak:.2f} GiB; host pipeline alone "
                f"{img_per_s:.1f} img/s over {TAR_HOST_BATCHES} batches ({workers} workers, "
                f"os.cpu_count() {os.cpu_count()}); epochs {epoch_s} s; launches {launches} "
                f"({card})")
            out["runs"][name] = {
                "flags": flags, "steps": steps, "step_ms": step_ms,
                "samples_per_s": TRAIN_BATCH / step_ms * 1e3, "data_ms": data_ms,
                "device_idle_pct": float(idle[-1]), "h2d_bytes": h2d, "peak_gib": peak,
                "host_img_per_s": img_per_s, "launches": launches, "losses": losses,
                "epoch_s": epoch_s, "seconds": secs}
            torch.cuda.empty_cache()
        if has_jpeg:
            # the native decoder against the PIL transform on the same boxes
            import io
            import random
            import tarfile

            from PIL import Image

            with tarfile.open(paths[0]) as tf:
                jpegs = [tf.extractfile(m).read() for m in tf.getmembers()
                         if m.name.endswith(".jpg")][:16]
            boxes, want = [], []
            pil = image_transform(size, True)
            for i, data in enumerate(jpegs):
                img = Image.open(io.BytesIO(data))
                boxes.append(sample_rrc_box(*img.size, rng=random.Random(i)))
                want.append(pil(img, rng=random.Random(i)))
            got, failures = native.process_batch(jpegs, (size, size), OPENAI_DATASET_MEAN,
                                                 OPENAI_DATASET_STD,
                                                 crops=np.asarray(boxes, np.int32))
            rms = float(np.sqrt(np.mean(((got - np.stack(want))
                                         * np.asarray(OPENAI_DATASET_STD) * 255) ** 2)))
            log(f"[11 tar] (b) native decode of {len(jpegs)} samples against the PIL "
                f"transform on the same boxes: RMS {rms:.3f} pixel units (bar {NATIVE_RMS_MAX})")
            if failures or not rms < NATIVE_RMS_MAX:
                raise RuntimeError(f"native decode: {failures} failures, RMS {rms}")
            out["native_rms"] = rms
    return out


def dist_modes():
    """Phase 12's four modes: (name, TrainStepConfig keywords, launches a
    step as the code implies them at one rank). Full mode keeps the default
    gather (no gradient through it); the local-loss modes gather with
    gradient, which at one rank makes their loss the one-device loss term for
    term (without it each direction's gradient stops at its own rows, by
    design). Local loss runs MaxSim twice a step (text rows over the
    gathered images, the gathered texts over the local images), as does the
    ring at one rank (one block each way); the clip mode runs each CE kernel
    twice a step (image rows, text rows)."""
    attn = {"fused_attention_fwd": 2 * TOWER_LAYERS, "fused_attention_bwd": 2 * TOWER_LAYERS}
    no_ce = {"fused_ce_fwd": 0, "fused_ce_bwd_da": 0, "fused_ce_bwd_db": 0}
    return [
        ("colclip_full", dict(loss_type="colclip"),
         {**attn, "maxsim_fwd": 1, "maxsim_bwd": 1, **no_ce}),
        ("colclip_local", dict(loss_type="colclip", local_loss=True, gather_with_grad=True),
         {**attn, "maxsim_fwd": 2, "maxsim_bwd": 2, **no_ce}),
        ("colclip_local_ring_cap2",
         dict(loss_type="colclip", local_loss=True, gather_with_grad=True, token_dist="ring",
              token_neighborhood=2),
         {**attn, "maxsim_fwd": 2, "maxsim_bwd": 2, **no_ce}),
        ("clip_local_fused", dict(loss_type="clip", local_loss=True, gather_with_grad=True,
                                  ce_impl="fused"),
         {**attn, "maxsim_fwd": 0, "maxsim_bwd": 0, "fused_ce_fwd": 2, "fused_ce_bwd_da": 2,
          "fused_ce_bwd_db": 2}),
    ]


def dist_counters():
    from colxlip_tpu_torch.ops import attention, fused_ce, maxsim

    return {"fused_attention_fwd": attention.LAUNCHES,
            "fused_attention_bwd": attention.BWD_LAUNCHES,
            "maxsim_fwd": maxsim.LAUNCHES, "maxsim_bwd": maxsim.BWD_LAUNCHES,
            "fused_ce_fwd": fused_ce.FWD_LAUNCHES, "fused_ce_bwd_da": fused_ce.BWD_DA_LAUNCHES,
            "fused_ce_bwd_db": fused_ce.BWD_DB_LAUNCHES}


def dist_step(dev, dtype, ref_state, step_cfg, images, texts, group, steps: int,
              profile_tag=None, card: str = ""):
    """``steps`` train steps at learning rate 0 (the weights stay) from
    ``ref_state`` in ``dtype`` compute: one device (group None) or the
    data-parallel group; with ``profile_tag`` one more step under the
    profiler. Returns (the first step's metrics, its gradients, launches of
    the first step, the median ms of the later steps, peak GiB)."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    model, _ = create_model(MODEL, dev, dtype, seed=0)
    model.load_state_dict(ref_state)
    model.train()
    zero = const_lr(0.0, 0)
    step = make_train_step(model, create_optimizer(model, zero), zero, step_cfg, mesh=group)
    counters = dist_counters()
    unused = fused_counters()
    for c in (*counters.values(), *unused.values()):
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = {k: float(v) for k, v in step(images, texts).items()}
    torch.cuda.synchronize()
    launches = {name: c.value for name, c in counters.items()}
    check_default_path(unused, "phase 12")
    grads = {k: p.grad.float().clone() for k, p in model.named_parameters()}
    secs = []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = statistics.median(secs) * 1e3 if secs else float("nan")
    if profile_tag is not None:
        profile_step(step, images, texts, card, tag=profile_tag)
    del step, model
    torch.cuda.empty_cache()
    return metrics, grads, launches, ms, peak


def compare_dist(label: str, got_metrics, want_metrics, got_grads, want_grads) -> dict:
    """The group step against the one-device step: the losses' largest
    relative difference, the gradients' lowest cosine and largest relative
    norm difference, and whether everything is equal bit for bit."""
    loss_err = max(abs(got_metrics[k] - want_metrics[k]) / max(abs(want_metrics[k]), 1e-30)
                   for k in want_metrics if k.endswith("loss"))
    cos_min, norm_err, equal, worst = grad_agreement(got_grads, want_grads)
    same_metrics = all(got_metrics[k] == want_metrics[k] for k in want_metrics)
    log(f"[12 dist] {label}: group step " + " ".join(f"{k} {v:.6f}" for k, v in
                                                       got_metrics.items())
        + "; one device " + " ".join(f"{k} {v:.6f}" for k, v in want_metrics.items()))
    log(f"[12 dist] {label}: max rel loss diff {loss_err:.3g}, lowest grad cosine "
        f"{cos_min:.7f} ({', '.join(f'{k} {v:.7f}' for k, v in worst.items())}), max rel "
        f"grad-norm diff {norm_err:.3g}, metrics {'bit-equal' if same_metrics else 'differ'}, "
        f"gradients {'bit-equal' if equal else 'differ'}")
    return {"loss_rel_err": loss_err, "grad_cos_min": cos_min, "grad_norm_rel_err": norm_err,
            "bit_equal": same_metrics and equal}


def grad_agreement(got, want):
    """(lowest per-tensor cosine, largest relative norm difference, whether
    every tensor is equal bit for bit, the three tensors of lowest cosine)."""
    import torch

    cosines, norm_err, equal = {}, 0.0, True
    for name, w in want.items():
        g = got[name]
        equal = equal and torch.equal(g, w)
        nw, ng = w.norm().item(), g.norm().item()
        if nw == 0 and ng == 0:
            continue
        cosines[name] = (g * w).sum().item() / max(nw * ng, 1e-30)
        norm_err = max(norm_err, abs(ng - nw) / max(nw, 1e-30))
    worst = sorted(cosines, key=cosines.get)[:3]
    return cosines[worst[0]], norm_err, equal, {k: cosines[k] for k in worst}


def check_dist_helpers(dev, group, model_state) -> list:
    """Phase 12b: every collective main and the train step call, once each
    on the group with tensors on the card; returns the names checked."""
    import torch
    import torch.distributed as dist

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.mesh import broadcast_str, collective_device
    from colxlip_tpu_torch.parallel.train_step import all_reduce_mean_, broadcast_parameters
    from colxlip_tpu_torch.training.train import _stop_consensus

    if collective_device(group) != dev:
        raise RuntimeError(f"phase 12: the group's device {collective_device(group)} is not {dev}")
    name = "2026_10_17-12_00_00-model_ViT-B-16-colxlip-lr_0.0005-b_256-p_amp_bf16"
    path = "/logs/run/checkpoints/epoch_latest"
    if broadcast_str(name, group) != name or broadcast_str(path, group) != path \
            or broadcast_str("", group) != "":
        raise RuntimeError("phase 12: the name / resume-path broadcast changed its string")
    if _stop_consensus(True, group, dev) is not True or \
            _stop_consensus(False, group, dev) is not False:
        raise RuntimeError("phase 12: the stop consensus disagrees with the one rank's flag")
    dist.barrier(group)          # main's wait for rank 0's eval and last save
    grads = [torch.randn(1000, generator=torch.Generator().manual_seed(i)).to(dev)
             for i in range(3)]
    want = [g.clone() for g in grads]
    all_reduce_mean_(grads, group)
    if not all(torch.equal(g, w) for g, w in zip(grads, want)):
        raise RuntimeError("phase 12: the gradient all-reduce of one rank changed its values")
    model, _ = create_model(MODEL, dev, torch.bfloat16, seed=1)
    model.load_state_dict(model_state)
    broadcast_parameters(model, group)
    if not all(torch.equal(p, model_state[k]) for k, p in model.named_parameters()):
        raise RuntimeError("phase 12: the parameter broadcast of one rank changed them")
    del model
    torch.cuda.empty_cache()
    return ["broadcast_str (run name, resume path)", "stop consensus (int32 MAX)", "barrier",
            "gradient all-reduce (coalesced SUM / world)", "parameter broadcast"]


def check_maxsim_rects(dev, gen, shapes, tag: str, label: str, card: str) -> dict:
    """#5 and #6 at the rectangles ``shapes`` (text items T x image items I;
    77 x 197 tokens, D 512; bf16), each against its plain version with phase
    3's tolerances, timed beside the plain version and the bound."""
    import torch

    from colxlip_tpu_torch.ops import maxsim

    out = {}
    lt, li, d = 77, 197, 512
    for m, k in shapes:
        t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
        eot = torch.randint(3, lt, (m,), generator=gen)
        t = t * (torch.arange(lt)[None, :] < eot[:, None])[:, :, None]
        img = torch.nn.functional.normalize(torch.randn(k, li, d, generator=gen), dim=-1)
        g = (torch.randn(m, k, generator=gen) / m).to(dev)
        tt, ii = t.to(dev, torch.bfloat16), img.to(dev, torch.bfloat16)
        fwd_err = check_maxsim_forward(tt, ii, "nonzero", None, label)
        got = maxsim._launch_bwd(tt, ii, g, "nonzero", None)
        want = maxsim.maxsim_bwd_plain(tt, ii, g)
        torch.cuda.synchronize()
        bwd_err = max(max_rel_err(a, w) for a, w in zip(got, want))
        tol = BWD_TOL["bfloat16"]
        log(f"{tag} maxsim bwd M={m} K={k} Lt={lt} Li={li} D={d} bfloat16: max_abs_err / "
            f"max|grad| {bwd_err:.3g} (tol {tol}) (dT, dI)")
        if not bwd_err <= tol:
            raise RuntimeError(f"{tag} maxsim bwd {m} x {k}: {bwd_err} > {tol}")
        del got, want
        row = {"maxsim_fwd": (cuda_ms(lambda: maxsim._launch_fwd(tt, ii, "nonzero", None), 5),
                              cuda_ms(lambda: maxsim.maxsim_plain(tt, ii), 3),
                              maxsim_bound(tt, ii, False), fwd_err),
               "maxsim_bwd": (cuda_ms(lambda: maxsim._launch_bwd(tt, ii, g, "nonzero", None), 5),
                              cuda_ms(lambda: maxsim.maxsim_bwd_plain(tt, ii, g), 3),
                              maxsim_bound(tt, ii, True), bwd_err)}
        for name, (ker, plain, (bound, by), err) in row.items():
            out[f"{name}/{m}x{k}"] = {"ms": ker, "plain_ms": plain, "bound_ms": bound,
                                      "bound_by": by, "max_abs_err": err}
            log(f"{tag} {name} T {m} x I {k} bf16: kernel {ker:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bound:.5f} ms ({by}) ({card})")
        del tt, ii, g
    return out


def check_dist_kernels(dev, gen, card: str) -> dict:
    """Phase 12c: #5 and #6 at a 4-rank step's local-loss rectangles (T 256 x
    I 1024 and T 1024 x I 256; 77 x 197 tokens, D 512; bf16) and #11-13 at
    M 256, N 1024, D 512 with labels offset by 768 (rank 3's rows), bf16 and
    fp32, each against its plain version with phase 3's tolerances, timed
    beside the plain version and the bound."""
    import torch

    from colxlip_tpu_torch.ops import fused_ce

    out = check_maxsim_rects(dev, gen, DIST_MAXSIM_SHAPES, "[12 dist]", "4-rank", card)
    m, n, offset = DIST_CE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        a, b, _, s, g = ce_inputs(m, n, 512, 1 / 0.07, dtype, dev, gen)
        labels = (torch.arange(m, dtype=torch.int32) + offset).to(dev)
        loss, lse = fused_ce._launch_fwd(a, b, labels, s)
        da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
        db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
        want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
        want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
        want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
        torch.cuda.synchronize()
        fwd_err = max(((x - w).abs() / (1 + w.abs())).max().item()
                      for x, w in ((loss, want_loss), (lse, want_lse)))
        da_err = max(max_rel_err(da, want_da), max_rel_err(ds, want_ds))
        db_err = max_rel_err(db, want_db)
        name = str(dtype).split(".")[-1]
        log(f"[12 dist] fused CE M={m} N={n} D=512 labels {offset}..{offset + m - 1} {name}: fwd "
            f"|err| / (1 + |loss|) {fwd_err:.3g} (tol {CE_FWD_TOL}); max_abs_err / max|grad| "
            f"dA+dscale {da_err:.3g}, dB {db_err:.3g} (tol {CE_BWD_TOL}); loss mean "
            f"{loss.mean().item():.5f}")
        if not (fwd_err <= CE_FWD_TOL and da_err <= CE_BWD_TOL and db_err <= CE_BWD_TOL
                and torch.isfinite(loss).all()):
            raise RuntimeError(f"phase 12 fused CE {m} x {n} {name}: {fwd_err} {da_err} {db_err}")
        bounds = ce_bounds(a, b)
        timed = {
            "fused_ce_fwd": (lambda: fused_ce._launch_fwd(a, b, labels, s),
                             lambda: fused_ce.fused_ce_fwd_plain(a, b, labels, s), fwd_err),
            "fused_ce_bwd_da": (lambda: fused_ce._launch_bwd_da(a, b, labels, s, lse, g),
                                lambda: fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g),
                                da_err),
            "fused_ce_bwd_db": (lambda: fused_ce._launch_bwd_db(a, b, labels, s, lse, g),
                                lambda: fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g),
                                db_err)}
        for key, (ker_fn, plain_fn, err) in timed.items():
            ker, plain = cuda_ms(ker_fn, 20), cuda_ms(plain_fn, 20)
            bound, by = bounds[key]
            out[f"{key}/{m}x{n}/{name}"] = {"ms": ker, "plain_ms": plain, "bound_ms": bound,
                                            "bound_by": by, "max_abs_err": err}
            log(f"[12 dist] {key} M={m} N={n} D=512 {name}: kernel {ker:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bound:.5f} ms ({by}) ({card})")
    return out


def dist_phase(dev, card: str, train):
    """Phase 12: data parallelism under a process group of one on the card
    (NCCL refuses two ranks on one GPU). (a) make_train_step(mesh=group) on
    ViT-B-16-colxlip, bf16, batch 256, in four modes, each against the
    one-device step on the same weights and batch (the three local-loss
    modes' gradients also in fp32 compute); (b) the collectives of main;
    (c) kernels #5-6 and #11-13 at a 4-rank step's shapes. Every mode is
    read before the phase fails."""
    import torch
    import torch.distributed as dist

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

    t0 = time.perf_counter()
    port = free_port()
    if DIST_BACKEND == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(DIST_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    group = dist.group.WORLD
    try:
        log(f"[12 dist] process group: {dist.get_backend(group)}, world size "
            f"{dist.get_world_size(group)}, rank {dist.get_rank(group)}, tcp://127.0.0.1:{port} "
            f"({time.perf_counter() - t0:.1f} s)")
        model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
        ref_state = copy.deepcopy(model.state_dict())
        del model
        images, texts = synthetic_batch(TRAIN_BATCH, cfg.vision_cfg.image_size,
                                        cfg.text_cfg.context_length, seed=12)
        images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
        modes, failures = {}, []
        for name, kw, want_launches in dist_modes():
            step_cfg = TrainStepConfig(**kw)
            # bf16, the path a user runs: launches, ms and peak; one profiled
            # step each way in full mode
            tags = ("[12 dist one device]", "[12 dist group]") if name == "colclip_full" \
                else (None, None)
            m1, g1, l1, ms1, peak1 = dist_step(dev, torch.bfloat16, ref_state, step_cfg,
                                               images, texts, None, DIST_STEPS, tags[0], card)
            mg, gg, lg, msg, peakg = dist_step(dev, torch.bfloat16, ref_state, step_cfg,
                                               images, texts, group, DIST_STEPS, tags[1], card)
            readings = {"bfloat16": compare_dist(f"{name} bf16", mg, m1, gg, g1)}
            del g1, gg
            log(f"[12 dist] {name}: launches a step {lg} (one device {l1})")
            log(f"[12 dist] {name}: step {msg:.2f} ms at batch {TRAIN_BATCH} under the group "
                f"({TRAIN_BATCH / msg * 1e3:.1f} img/s), {ms1:.2f} ms on one device, phase 6 "
                f"{train['step_ms']:.2f} ms; peak device memory {peakg:.2f} GiB (one device "
                f"{peak1:.2f}, phase 6 {train['peak_gib']:.2f}) ({card})")
            if lg != want_launches:
                failures.append(f"{name}: launches {lg}, expected {want_launches}")
            if name == "colclip_full":
                if not readings["bfloat16"]["bit_equal"]:
                    failures.append(f"{name}: the group step is not bit-equal to the "
                                    "one-device step")
            else:
                # the same step in fp32 compute, where only the order of the
                # sums differs, holds the gradient bar; bf16 rounds each of the
                # two MaxSim calls' dT and dI apart before autograd adds them,
                # and is held to phase 6's bf16 bar
                m1, g1, *_ = dist_step(dev, torch.float32, ref_state, step_cfg, images, texts,
                                       None, 1)
                mg, gg, *_ = dist_step(dev, torch.float32, ref_state, step_cfg, images, texts,
                                       group, 1)
                readings["float32"] = compare_dist(f"{name} fp32", mg, m1, gg, g1)
                del g1, gg
                for dtype, r in readings.items():
                    cos_min, norm_tol, _ = STEP_TOL[dtype]
                    if not (r["loss_rel_err"] <= DIST_LOSS_TOL and r["grad_cos_min"] >= cos_min
                            and r["grad_norm_rel_err"] <= norm_tol):
                        failures.append(f"{name} {dtype}: {r} outside ({DIST_LOSS_TOL}, "
                                        f"{cos_min}, {norm_tol})")
            modes[name] = {"ms": msg, "one_device_ms": ms1, "peak_gib": peakg,
                           "one_device_peak_gib": peak1, "launches": lg, **{
                               f"{dtype}_{k}": v for dtype, r in readings.items()
                               for k, v in r.items()}}
        helpers = check_dist_helpers(dev, group, ref_state)
        log(f"[12 dist] under {dist.get_backend(group)} with tensors on {dev}: "
            + "; ".join(helpers) + " - each as the one rank's own values")
        del ref_state, images, texts
        torch.cuda.empty_cache()
        kernels = check_dist_kernels(dev, torch.Generator().manual_seed(12), card)
    finally:
        dist.destroy_process_group()
    log(f"[12 dist] phase 12 took {time.perf_counter() - t0:.1f} s ({card})")
    if failures:
        raise RuntimeError("phase 12: " + "; ".join(failures))
    return {"modes": modes, "kernels": kernels}


def family_counters():
    """Every launch counter of the port's training kernels, by kernel name."""
    return {**dist_counters(), **fused_counters()}


def family_main(dev, card: str, name: str, model: str, extra, want_fwd: int, want_bwd: int,
                logs: str, terms=("total_loss",), falling=True, other_launches=None,
                tag: str = "[13 families]"):
    """``main`` on one seeded synthetic batch of FAMILY_BATCH (train-num-samples
    = the batch, so each of FAMILY_STEPS epochs is one step on the same batch,
    which the losses must learn): rc 0, finite losses (falling where asked),
    the attention launches exact (the other kernels none, or a step's
    ``other_launches``). Returns (the metrics records, launches, peak GiB,
    the train step main built)."""
    import torch

    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    argv = ["--model", model, "--dataset-type", "synthetic", "--batch-size", str(FAMILY_BATCH),
            "--train-num-samples", str(FAMILY_BATCH), "--epochs", str(FAMILY_STEPS),
            "--precision", "bf16", "--lr", "2e-4", "--warmup", "2", "--log-every-n-steps", "1",
            "--save-frequency", "0", "--workers", "0", "--seed", "0", "--logs", logs,
            "--name", name, *extra]
    log(f"{tag} python -m colxlip_tpu_torch.main {' '.join(argv)}")
    counters = family_counters()
    for c in counters.values():
        c.reset()
    steps, build = [], entry.make_train_step
    entry.make_train_step = lambda *a, **k: steps.append(build(*a, **k)) or steps[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        rc = entry.main(argv)
        torch.cuda.synchronize()
    finally:
        entry.make_train_step = build
        setup_logging(None)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {k: c.value for k, c in counters.items() if c.value}
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    log(f"{tag} {name}: rc {rc} in {secs:.1f} s; "
        + "; ".join(f"{t} " + " ".join(f"{r[t]:.5f}" for r in recs) for t in terms)
        + f"; launches {launches}; peak {peak:.2f} GiB ({card})")
    if rc != 0 or [r["step"] for r in recs] != list(range(1, FAMILY_STEPS + 1)):
        raise RuntimeError(f"{name}: rc {rc}, steps {[r['step'] for r in recs]}")
    for t in terms:
        vals = [r[t] for r in recs]
        if not all(math.isfinite(v) for v in vals) or (falling and not vals[-1] < vals[0]):
            raise RuntimeError(f"{name}: {t} {vals} (finite{' and falling' if falling else ''})")
    want = {k: n * FAMILY_STEPS for k, n in {"fused_attention_fwd": want_fwd,
                                            "fused_attention_bwd": want_bwd,
                                            **(other_launches or {})}.items()}
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, expected {want}")
    return recs, launches, peak, steps[0]


def family_batch(model_name: str, dev):
    """synthetic_batch (seed 13) of FAMILY_BATCH at the model's image size and
    context, on the card."""
    import torch

    from colxlip_tpu_torch.factory import model_config

    cfg = model_config(model_name)
    images, texts = synthetic_batch(FAMILY_BATCH, cfg.vision_cfg.image_size,
                                    cfg.text_cfg.context_length, seed=13)
    return torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)


def family_step_ms(dev, model_name: str, step_cfg, images, texts, teacher=None, steps: int = 4,
                   param_dtype=None):
    """``steps`` train steps at learning rate 0 on one device-resident batch:
    (the first step's metrics, the median ms of the later ones, peak GiB).
    ``param_dtype``: the parameters' dtype (default fp32)."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    model, _ = create_model(model_name, dev, torch.bfloat16, seed=0,
                            param_dtype=param_dtype or torch.float32)
    model.train()
    zero = const_lr(0.0, 0)
    step = make_train_step(model, create_optimizer(model, zero), zero, step_cfg, teacher=teacher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    first, secs = None, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        first = first or {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del step, model
    torch.cuda.empty_cache()
    return first, statistics.median(secs[1:]) * 1e3, peak


def unit_rows_agreement(got, want):
    """(largest element difference, largest 1 - cosine) of the rows of two
    [B, V] tensors scaled to unit norm: phase 4's encode bars on logits."""
    import torch

    g = torch.nn.functional.normalize(got.float(), dim=-1)
    w = torch.nn.functional.normalize(want.float(), dim=-1)
    return (g - w).abs().max().item(), (1 - (g * w).sum(-1)).max().item()


def caption_phase(dev, card: str):
    """Phase 13 (d): /v1/caption on a seeded COCA_MODEL over HTTP."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention
    from colxlip_tpu_torch.serving.generate import SOT, generate_captions, tokens_to_text
    from colxlip_tpu_torch.serving.server import ColXLIPService, make_server

    t0 = time.perf_counter()
    svc = ColXLIPService(COCA_MODEL, device=dev, max_batch=MAX_BATCH, seed=0)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    ctx = svc.cfg.text_cfg.context_length
    rng = np.random.default_rng(13)
    jpegs = [jpeg_b64(rng, int(rng.integers(200, 320)), int(rng.integers(200, 320)))
             for _ in range(MAX_BATCH)]
    out = {}
    try:
        log(f"[13 caption] {COCA_MODEL} random init (seed 0) on {dev}, bf16, serving on port "
            f"{port} ({time.perf_counter() - t0:.1f} s)")
        http(port, "/v1/caption", {"images_b64": jpegs[:1], "max_len": 3})     # warm-up
        counters = family_counters()
        for c in counters.values():
            c.reset()
        resp, secs = http(port, "/v1/caption", {"images_b64": jpegs[:CAPTION_IMAGES]})
        torch.cuda.synchronize()
        launches = {k: c.value for k, c in counters.items() if c.value}
        want_launches = {"fused_attention_fwd": COCA_LAYERS * ctx}   # the image once, 75 steps
        caps = resp["captions"]
        imgs = svc.decode_images(jpegs[:CAPTION_IMAGES])
        tokens = generate_captions(svc.model, imgs)
        with plain_versions():
            plain_tokens = generate_captions(svc.model, imgs)
        agree = int((tokens == plain_tokens).all(axis=1).sum())
        x = torch.from_numpy(imgs).to(dev)
        buf = torch.zeros((CAPTION_IMAGES, ctx), dtype=torch.long, device=dev)
        buf[:, 0] = SOT
        with torch.inference_mode():
            first = svc.model.caption_logits(buf, svc.model.embed_images(x))[:, 0]
            with plain_versions():
                first_plain = svc.model.caption_logits(buf, svc.model.embed_images(x))[:, 0]
        err, off = unit_rows_agreement(first, first_plain)
        log(f"[13 caption] /v1/caption greedy, {CAPTION_IMAGES} JPEGs: HTTP 200 in "
            f"{secs * 1e3:.1f} ms, {len(caps)} strings; launches {launches} (expected "
            f"{want_launches}); bf16 tokens equal the plain versions' in {agree} of "
            f"{CAPTION_IMAGES} rows; first step's logits (unit rows) vs plain: max err "
            f"{err:.3g} (tol {ENCODE_TOL}), 1 - cosine {off:.3g} (tol {ENCODE_COSINE_TOL})")
        if len(caps) != CAPTION_IMAGES or caps != tokens_to_text(tokens, svc.tokenizer):
            raise RuntimeError(f"/v1/caption answered {caps}")
        if launches != want_launches:
            raise RuntimeError(f"/v1/caption launches {launches}, expected {want_launches}")
        if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL):
            raise RuntimeError("the first decode step's logits disagree with the plain versions")

        model32, _ = create_model(COCA_MODEL, dev, torch.float32, seed=0)
        tok32 = generate_captions(model32, imgs)
        with plain_versions():
            plain32 = generate_captions(model32, imgs)
        equal32 = bool((tok32 == plain32).all())
        log(f"[13 caption] fp32: greedy tokens through the kernels equal the plain versions': "
            f"{equal32} ({int((tok32 == plain32).all(axis=1).sum())} of {CAPTION_IMAGES} rows)")
        if not equal32:
            raise RuntimeError("fp32 greedy captions differ from the plain versions'")
        del model32

        lat = {n: [http(port, "/v1/caption", {"images_b64": jpegs[:n]})[1] * 1e3
                   for _ in range(3 if n == CAPTION_IMAGES else 2)]
               for n in (CAPTION_IMAGES, MAX_BATCH)}
        x64 = torch.from_numpy(svc.decode_images(jpegs)).to(dev)
        with torch.inference_mode():
            embs = svc.model.embed_images(x64)
            buf = torch.zeros((MAX_BATCH, ctx), dtype=torch.long, device=dev)
            buf[:, 0] = SOT
            m = svc.model
            step_ms = cuda_ms(lambda: m.vocab_logits(m.text_decoder(
                m.encode_text(buf)[1][:, :-1], embs)[:, ctx // 2]), 5)
            embed_ms = cuda_ms(lambda: m.embed_images(x64), 5)
        out = {"request_ms": {n: statistics.median(v) for n, v in lat.items()},
               "decode_step_ms_b64": step_ms, "embed_images_ms_b64": embed_ms,
               "launches": launches, "bf16_rows_equal_plain": agree,
               "first_logits_err": err, "first_logits_1_minus_cos": off,
               "fp32_tokens_equal_plain": equal32}
        log(f"[13 caption] request ms: batch {CAPTION_IMAGES} median "
            f"{out['request_ms'][CAPTION_IMAGES]:.1f}, batch {MAX_BATCH} median "
            f"{out['request_ms'][MAX_BATCH]:.1f}; at batch {MAX_BATCH} one decode step "
            f"(text tower + decoder over the {ctx}-token buffer + head) {step_ms:.3f} ms, "
            f"embed_images {embed_ms:.3f} ms; {ctx - 1} steps a caption ({card})")
    finally:
        httpd.shutdown()
        svc.stop()
        server.join(timeout=30)
    del svc
    torch.cuda.empty_cache()
    return out


def families_phase(dev, card: str):
    """Phase 13: the other loss families through main (SigLIP, distillation,
    CoCa dense and fused) and CoCa captioning over HTTP."""
    import torch

    from colxlip_tpu_torch.convert import load_pt_state_dict
    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig
    from colxlip_tpu_torch.training.checkpoint import save_pt_checkpoint

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as logs:
        # (a) SigLIP
        recs, launches, peak, _ = family_main(
            dev, card, "siglip", SIGLIP_MODEL, ["--siglip"], 2 * TOWER_LAYERS,
            2 * TOWER_LAYERS, logs)
        images, texts = family_batch(SIGLIP_MODEL, dev)
        cfg = TrainStepConfig(loss_type="siglip")
        _, ms, step_peak = family_step_ms(dev, SIGLIP_MODEL, cfg, images, texts)
        log(f"[13 families] siglip {SIGLIP_MODEL} batch {FAMILY_BATCH} bf16: step {ms:.2f} ms = "
            f"{FAMILY_BATCH / ms * 1e3:.1f} img/s, peak {step_peak:.2f} GiB ({card})")
        compare_step(dev, torch.bfloat16, None, cfg, images[:COMPARE_BATCH],
                     texts[:COMPARE_BATCH], tag="[13 siglip]", model_name=SIGLIP_MODEL)
        res["siglip"] = {"model": SIGLIP_MODEL, "losses": [r["total_loss"] for r in recs],
                         "launches": launches, "main_peak_gib": peak, "step_ms": ms,
                         "img_per_s": FAMILY_BATCH / ms * 1e3, "peak_gib": step_peak}

        # (b) distillation from a seeded teacher .pt
        teacher, _ = create_model(DISTILL_TEACHER, "cpu", torch.float32, seed=7)
        pt = save_pt_checkpoint(os.path.join(logs, "teacher.pt"), teacher)
        del teacher
        want_sd = load_pt_state_dict(pt)
        recs, launches, peak, step = family_main(
            dev, card, "distill", DISTILL_STUDENT,
            ["--distill-model", DISTILL_TEACHER, "--distill-pretrained", pt],
            4 * TOWER_LAYERS, 2 * TOWER_LAYERS, logs,
            terms=("total_loss", "contrastive_loss", "distill_loss"), falling=False)
        got_sd = step.teacher.state_dict()
        equal = set(got_sd) == set(want_sd) and all(
            torch.equal(got_sd[k].cpu(), want_sd[k]) for k in want_sd)
        frozen = not any(p.requires_grad for p in step.teacher.parameters())
        log(f"[13 families] distill: the teacher's state dict after {FAMILY_STEPS} steps equals "
            f"its .pt bit for bit: {equal}; no teacher parameter takes a gradient: {frozen}")
        if not (equal and frozen):
            raise RuntimeError("the distillation teacher moved or takes gradients")
        teacher = step.teacher
        del step
        torch.cuda.empty_cache()
        cfg = TrainStepConfig(loss_type="distill")
        _, ms, step_peak = family_step_ms(dev, DISTILL_STUDENT, cfg, images, texts,
                                          teacher=teacher)
        del teacher
        log(f"[13 families] distill {DISTILL_STUDENT} <- {DISTILL_TEACHER} batch {FAMILY_BATCH} "
            f"bf16: step {ms:.2f} ms = {FAMILY_BATCH / ms * 1e3:.1f} img/s, peak "
            f"{step_peak:.2f} GiB ({card})")
        res["distill"] = {"student": DISTILL_STUDENT, "teacher": DISTILL_TEACHER,
                          "losses": {t: [r[t] for r in recs] for t in (
                              "total_loss", "contrastive_loss", "distill_loss")},
                          "launches": launches, "main_peak_gib": peak, "step_ms": ms,
                          "img_per_s": FAMILY_BATCH / ms * 1e3, "peak_gib": step_peak}

        # (c) CoCa training, the caption CE dense and streamed
        res["coca"] = {"model": COCA_MODEL}
        images, texts = family_batch(COCA_MODEL, dev)
        first = {}
        for ce in ("dense", "fused"):
            recs, launches, peak, _ = family_main(
                dev, card, f"coca_{ce}", COCA_MODEL, ["--ce-impl", ce], 2 * TOWER_LAYERS,
                2 * TOWER_LAYERS, logs, terms=("total_loss", "contrastive_loss", "caption_loss"))
            cfg = TrainStepConfig(loss_type="coca", ce_impl=ce)
            first[ce], ms, step_peak = family_step_ms(dev, COCA_MODEL, cfg, images, texts)
            log(f"[13 families] coca --ce-impl {ce}, {COCA_MODEL} batch {FAMILY_BATCH} bf16: "
                f"step {ms:.2f} ms = {FAMILY_BATCH / ms * 1e3:.1f} img/s, peak "
                f"{step_peak:.2f} GiB; main's peak {peak:.2f} GiB ({card})")
            res["coca"][ce] = {"losses": {t: [r[t] for r in recs] for t in (
                "total_loss", "contrastive_loss", "caption_loss")}, "launches": launches,
                "main_peak_gib": peak, "step_ms": ms, "img_per_s": FAMILY_BATCH / ms * 1e3,
                "peak_gib": step_peak}
        diff = abs(first["fused"]["caption_loss"] - first["dense"]["caption_loss"]) / abs(
            first["dense"]["caption_loss"])
        lower = res["coca"]["fused"]["peak_gib"] < res["coca"]["dense"]["peak_gib"]
        log(f"[13 families] coca caption_loss on one batch and weights: dense "
            f"{first['dense']['caption_loss']:.6f}, fused {first['fused']['caption_loss']:.6f}, "
            f"relative difference {diff:.3g} (tol {CAPTION_FUSED_TOL}); the fused step's peak "
            f"below the dense one's: {lower}")
        if not (diff <= CAPTION_FUSED_TOL and lower):
            raise RuntimeError("the streamed caption CE disagrees with the dense one, or holds "
                               "more memory")
        res["coca"]["caption_loss_rel_diff"] = diff
        compare_step(dev, torch.bfloat16, None, TrainStepConfig(loss_type="coca"),
                     images[:COMPARE_BATCH], texts[:COMPARE_BATCH], tag="[13 coca]",
                     model_name=COCA_MODEL)

    # (d) captioning over HTTP
    res["caption"] = caption_phase(dev, card)
    log(f"[13 families] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return res


def pod_cfg(k=None):
    """The recipes' loss flags, the ring window K (default POD_K)."""
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

    return TrainStepConfig(loss_type="colclip", alpha=POD_ALPHA, local_loss=True,
                           gather_with_grad=True, token_dist="ring",
                           token_neighborhood=k or POD_K)


def pod_make_step(m: int, mode: str):
    """make_step for compare_step: the pod-shape step at M = ``m``."""
    from colxlip_tpu_torch.parallel.pod_shape import make_pod_shape_step

    return lambda model, opt, sched, cfg: make_pod_shape_step(
        model, opt, sched, cfg, pod_devices=m, window_mode=mode)


def pod_run(dev, card: str, model_name: str, batch: int, mode: str, ctx=None) -> dict:
    """POD_STEPS pod-shape steps (M = POD_DEVICES, K = POD_K) at learning rate
    0 on one seeded device-resident batch, bf16, at ``ctx`` text tokens (the
    model's context by default): launches a step exact, ms a step (median of
    steps 2-4), img/s, peak; then one profiled step's MaxSim share of the
    device time."""
    import torch

    from colxlip_tpu_torch.factory import create_model, model_config
    from colxlip_tpu_torch.parallel.pod_shape import make_pod_shape_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    cfg = model_config(model_name)
    ctx = ctx or cfg.text_cfg.context_length
    images, texts = synthetic_batch(batch, cfg.vision_cfg.image_size, ctx, seed=14)
    images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
    model, _ = create_model(model_name, dev, torch.bfloat16, seed=0)
    model.train()
    zero = const_lr(0.0, 0)
    step = make_pod_shape_step(model, create_optimizer(model, zero), zero, pod_cfg(),
                               pod_devices=POD_DEVICES, window_mode=mode)
    layers = cfg.vision_cfg.layers + cfg.text_cfg.layers
    calls = 2 * POD_K if mode == "scan" else 2
    want = {"fused_attention_fwd": layers, "fused_attention_bwd": layers,
            "maxsim_fwd": calls, "maxsim_bwd": calls, "fused_ce_fwd": 0,
            "fused_ce_bwd_da": 0, "fused_ce_bwd_db": 0}
    counters, unused = dist_counters(), fused_counters()
    for c in (*counters.values(), *unused.values()):
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs, first = [], None
    for _ in range(POD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        first = first or {k: float(v) for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {k: c.value for k, c in counters.items()}
    check_default_path(unused, "phase 14")
    if launches != {k: n * POD_STEPS for k, n in want.items()}:
        raise RuntimeError(f"phase 14 {model_name} {mode}: launches over {POD_STEPS} steps "
                           f"{launches}, expected {want} a step")
    if not all(math.isfinite(v) for v in first.values()):
        raise RuntimeError(f"phase 14 {model_name} {mode}: metrics {first}")
    ms = statistics.median(secs[1:]) * 1e3
    events, wall_ms = profiled(lambda: step(images, texts))
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    maxsim_ms = sum(e.self_device_time_total for e in kernels if "maxsim" in e.key) / 1e3
    label = f"{model_name} b {batch} ctx {ctx} {mode}"
    log(f"[14 pod] {label}: M {POD_DEVICES} K {POD_K} alpha {POD_ALPHA}, bf16: step {ms:.2f} ms "
        f"= {batch / ms * 1e3:.1f} img/s a device, peak {peak:.2f} GiB; launches a step "
        f"{want}; total_loss {first['total_loss']:.5f}; profiled step: MaxSim {maxsim_ms:.2f} "
        f"of {device_ms:.2f} ms of kernels ({maxsim_ms / device_ms:.1%}) in {wall_ms:.1f} ms "
        f"({card})")
    del step, model, images, texts
    torch.cuda.empty_cache()
    return {"model": model_name, "batch": batch, "ctx": ctx, "window_mode": mode,
            "step_ms": ms, "img_per_s": batch / ms * 1e3, "peak_gib": peak,
            "launches_per_step": want, "maxsim_device_ms": maxsim_ms,
            "device_ms": device_ms, "maxsim_share": maxsim_ms / device_ms,
            "first_metrics": first}


def pod_first_metrics(dev, dtype, ref_state, images, texts, mode: str) -> dict:
    """One pod-shape step (M, K = POD_COMPARE) at learning rate 0: its metrics."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    model, _ = create_model(POD_MODEL, dev, dtype, seed=0)
    model.load_state_dict(ref_state)
    model.train()
    zero = const_lr(0.0, 0)
    m, k = POD_COMPARE
    step = pod_make_step(m, mode)(model, create_optimizer(model, zero), zero, pod_cfg(k))
    metrics = {key: float(v) for key, v in step(images, texts).items()}
    del step, model
    torch.cuda.empty_cache()
    return metrics


def pod_phase(dev, card: str, train) -> dict:
    """Phase 14: one device's share of the pod recipes (parallel/pod_shape.py):
    ViT-B-16-colxlip at batch 256, M 64, K 8 in both window modes at 77 text
    tokens and 'scan' at --text-ctx 64, ViT-L-14-colxlip at batch 64 'scan'
    (halved until it fits, the cut printed); the batch-64 step (M 8, K 4)
    against the plain versions and 'scan' against 'fused' in fp32; #5 / #6 at
    the fused window's rectangles."""
    import torch

    from colxlip_tpu_torch.factory import create_model

    t_phase = time.perf_counter()
    runs = [pod_run(dev, card, POD_MODEL, POD_BATCH, mode) for mode in ("scan", "fused")]
    runs.append(pod_run(dev, card, POD_MODEL, POD_BATCH, "scan", POD_TEXT_CTX))
    batch, vit_l = POD_VIT_L_BATCH, None
    while vit_l is None:
        oom = None
        try:
            vit_l = pod_run(dev, card, VIT_L_MODEL, batch, "scan")
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0][:200]
        if oom is not None:       # the failed run's tensors are free once its frame is
            torch.cuda.empty_cache()
            log(f"[14 pod] {VIT_L_MODEL} batch {batch}: out of memory ({oom})")
            if batch == 1:
                raise RuntimeError(f"phase 14: {VIT_L_MODEL} does not fit at batch 1")
            batch //= 2
    vit_l["cut"] = None if batch == POD_VIT_L_BATCH else f"batch {POD_VIT_L_BATCH} -> {batch}"
    runs.append(vit_l)
    if vit_l["cut"]:
        log(f"[14 pod] {VIT_L_MODEL}: the largest batch that fits is {batch} (cut: "
            f"{vit_l['cut']})")
    scan, fused = runs[0], runs[1]
    log(f"[14 pod] {POD_MODEL} batch {POD_BATCH}: scan {scan['step_ms']:.2f} ms, fused "
        f"{fused['step_ms']:.2f} ms, --text-ctx {POD_TEXT_CTX} scan {runs[2]['step_ms']:.2f} ms; "
        f"phase 6's one-device step {train['step_ms']:.2f} ms ({card})")

    model, cfg = create_model(POD_MODEL, dev, torch.bfloat16, seed=0)
    ref_state = copy.deepcopy(model.state_dict())
    del model
    images, texts = synthetic_batch(COMPARE_BATCH, cfg.vision_cfg.image_size,
                                    cfg.text_cfg.context_length, seed=14)
    images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
    m, k = POD_COMPARE
    for dtype in (torch.float32, torch.bfloat16):
        compare_step(dev, dtype, ref_state, pod_cfg(k), images, texts,
                     tag=f"[14 pod M {m} K {k} scan]", model_name=POD_MODEL,
                     make_step=pod_make_step(m, "scan"))
    by_mode = {mode: pod_first_metrics(dev, torch.float32, ref_state, images, texts, mode)
               for mode in ("scan", "fused")}
    mode_err = max(abs(by_mode["fused"][key] - v) / max(abs(v), 1e-30)
                   for key, v in by_mode["scan"].items())
    log(f"[14 pod] batch {COMPARE_BATCH} M {m} K {k} fp32, 'scan' against 'fused': "
        + " ".join(f"{key} {v:.6f}/{by_mode['fused'][key]:.6f}" for key, v in by_mode["scan"].items())
        + f"; max relative difference {mode_err:.3g} (tol {POD_LOSS_TOL})")
    if not mode_err <= POD_LOSS_TOL:
        raise RuntimeError(f"phase 14: 'scan' and 'fused' disagree by {mode_err}")
    del ref_state, images, texts
    torch.cuda.empty_cache()
    kernels = check_maxsim_rects(dev, torch.Generator().manual_seed(14), POD_MAXSIM_SHAPES,
                                 "[14 pod]", "pod window", card)
    log(f"[14 pod] phase 14 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"runs": runs, "scan_vs_fused_fp32": mode_err, "kernels": kernels}


def assert_same_state(got, want, where: str) -> None:
    """Two checkpoint payloads hold the same structure and bit-equal tensors."""
    import torch

    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got.cpu(), want.cpu())):
            raise RuntimeError(f"{where}: the tensors differ")
    elif isinstance(want, dict):
        if list(got) != list(want):
            raise RuntimeError(f"{where}: keys differ")
        for key in want:
            assert_same_state(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise RuntimeError(f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(got, want)):
            assert_same_state(x, y, f"{where}[{i}]")
    elif got != want:
        raise RuntimeError(f"{where}: {got!r} != {want!r}")


def async_main_run(dev, card: str, logs: str) -> dict:
    """Phase 15 (a): main --async-checkpoint --save-frequency 1
    --save-most-recent --delete-previous-checkpoint, SAVE_EPOCHS epochs of
    SAVE_STEPS_PER_EPOCH steps. Each async save is preceded by a synchronous
    save of the same state into a side directory (timed); each async
    checkpoint must load bit-equal to it. Then --resume latest."""
    import torch

    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.training import checkpoint
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    side = os.path.join(logs, "sync_side")
    ckpts = os.path.join(logs, "async", "checkpoints")
    seconds = []
    real = entry.save_checkpoint_async

    def compare(epoch: int) -> None:
        want = checkpoint.load_native_checkpoint(os.path.join(side, f"epoch_{epoch}"))
        for tag in (f"epoch_{epoch}", "epoch_latest"):     # one snapshot wrote both
            got = checkpoint.load_native_checkpoint(os.path.join(ckpts, tag))
            assert_same_state(got, want, f"async {tag} against the sync save")
        shutil.rmtree(os.path.join(side, f"epoch_{epoch}"))

    def wrapped(checkpoint_dir, state, *, epoch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(side, state, epoch=epoch, name=kw.get("name", ""))
        sync_s = time.perf_counter() - t0
        checkpoint.wait_for_saves()
        if seconds:
            seconds[-1]["write"] = checkpoint.ASYNC_SECONDS["write"]
            compare(epoch - 1)
        real(checkpoint_dir, state, epoch=epoch, **kw)
        seconds.append({"epoch": epoch, "sync_save": sync_s,
                        "snapshot": checkpoint.ASYNC_SECONDS["snapshot"]})

    argv = ["--model", MAIN_MODEL, "--dataset-type", "synthetic", "--batch-size",
            str(TRAIN_BATCH), "--precision", "bf16", "--epochs", str(SAVE_EPOCHS),
            "--steps-per-epoch", str(SAVE_STEPS_PER_EPOCH), "--log-every-n-steps", "1",
            "--save-frequency", "1", "--save-most-recent", "--delete-previous-checkpoint",
            "--async-checkpoint", "--workers", "0", "--seed", "0", "--logs", logs,
            "--name", "async"]
    log(f"[15 saves] python -m colxlip_tpu_torch.main {' '.join(argv)}")
    unused = fused_counters()
    for c in unused.values():
        c.reset()
    entry.save_checkpoint_async = wrapped
    t0 = time.perf_counter()
    try:
        rc = entry.main(argv)
    finally:
        entry.save_checkpoint_async = real
        setup_logging(None)
    secs = time.perf_counter() - t0
    seconds[-1]["write"] = checkpoint.ASYNC_SECONDS["write"]   # main waited at exit
    if rc != 0 or sorted(os.listdir(ckpts)) != [f"epoch_{SAVE_EPOCHS}", "epoch_latest"]:
        raise RuntimeError(f"main --async-checkpoint: rc {rc}, {os.listdir(ckpts)}")
    check_default_path(unused, "phase 15")
    compare(SAVE_EPOCHS)
    for r in seconds:
        log(f"[15 saves] epoch {r['epoch']}: snapshot {r['snapshot']:.3f} s (blocking), "
            f"background write {r['write']:.3f} s (epoch_{r['epoch']}, epoch_latest and the "
            f"rotation); a synchronous save of the same state {r['sync_save']:.3f} s ({card})")
    log(f"[15 saves] rc 0 in {secs:.1f} s; {sorted(os.listdir(ckpts))} left by the rotation; every "
        f"async checkpoint (epoch_1..{SAVE_EPOCHS}, epoch_latest) loads bit-equal to the "
        "synchronous save of the same state")

    resume = [*argv, "--resume", "latest"]
    resume[resume.index("--epochs") + 1] = str(SAVE_EPOCHS + 1)
    try:
        rc = entry.main(resume)
    finally:
        setup_logging(None)
    base = os.path.join(logs, "async")
    with open(os.path.join(base, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    with open(os.path.join(base, "out.log")) as f:
        resumed = f"(epoch {SAVE_EPOCHS})" in f.read()
    total = (SAVE_EPOCHS + 1) * SAVE_STEPS_PER_EPOCH
    if rc != 0 or not resumed or steps != list(range(1, total + 1)):
        raise RuntimeError(f"--resume latest: rc {rc}, resumed at epoch {SAVE_EPOCHS}: "
                           f"{resumed}, steps {steps}")
    log(f"[15 saves] --epochs {SAVE_EPOCHS + 1} --resume latest: went on from epoch "
        f"{SAVE_EPOCHS} at step {SAVE_EPOCHS * SAVE_STEPS_PER_EPOCH + 1}; "
        f"{sorted(os.listdir(ckpts))}")
    return {"per_epoch": seconds, "main_s": secs}


def save_split(dev, card: str, logs: str) -> dict:
    """Phase 15 (a, continued): the resumed run's last state on the card
    (model and AdamW), saved three ways: synchronously, async with the host
    snapshot (pinned buffers, one synchronize) and async with the device
    snapshot ($COLXLIP_ASYNC_SNAPSHOT_HBM over the state's bytes); the three
    files bit-equal."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.training import checkpoint
    from colxlip_tpu_torch.training.optim import create_optimizer

    path = os.path.join(logs, "async", "checkpoints", f"epoch_{SAVE_EPOCHS + 1}")
    payload = checkpoint.load_native_checkpoint(path)
    model, _ = create_model(MAIN_MODEL, dev, torch.bfloat16, seed=0)
    model.train()
    opt = create_optimizer(model, 1e-4)
    checkpoint.restore_train_state(payload["state"], model, opt)
    del payload
    state = checkpoint.train_state(model, opt, 1)
    state_gib = sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 2**30
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(os.path.join(logs, "split"), state, epoch=0)
    out["sync_save_s"] = time.perf_counter() - t0
    want = checkpoint.load_native_checkpoint(os.path.join(logs, "split", "epoch_0"))
    for i, (snap, budget) in enumerate((("host", "0"), ("device", str(64 << 30)))):
        os.environ["COLXLIP_ASYNC_SNAPSHOT_HBM"] = budget
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_checkpoint_async(os.path.join(logs, "split"), state, epoch=i + 1)
            returned = time.perf_counter() - t0
            checkpoint.wait_for_saves()
        finally:
            os.environ.pop("COLXLIP_ASYNC_SNAPSHOT_HBM", None)
        out[f"{snap}_snapshot_s"] = checkpoint.ASYNC_SECONDS["snapshot"]
        out[f"{snap}_returned_s"] = returned
        out[f"{snap}_write_s"] = checkpoint.ASYNC_SECONDS["write"]
        got = checkpoint.load_native_checkpoint(os.path.join(logs, "split", f"epoch_{i + 1}"))
        assert_same_state(got["state"], want["state"],
                          f"async ({snap} snapshot) against the sync save")
        del got
    del want, state, model, opt
    torch.cuda.empty_cache()
    log(f"[15 saves] {MAIN_MODEL} train state ({state_gib:.2f} GiB of weights, AdamW moments "
        f"beside them): synchronous save {out['sync_save_s']:.3f} s; async with the host "
        f"snapshot: blocking {out['host_snapshot_s']:.3f} s, background write "
        f"{out['host_write_s']:.3f} s; with the device snapshot: blocking "
        f"{out['device_snapshot_s']:.3f} s, write {out['device_write_s']:.3f} s; the three "
        f"files bit-equal ({card})")
    return out


# a stand-in for the AWS CLI: ``aws s3 sync`` and ``aws s3 ls`` over a local
# directory ($AWS_STUB_ROOT holds the buckets), so that --remote-sync runs
# with no network
AWS_STUB = """#!{python}
import os, shutil, sys
args = sys.argv[1:]
root = os.environ["AWS_STUB_ROOT"]


def local(p):
    return os.path.join(root, p[len("s3://"):]) if p.startswith("s3://") else p


if args[:2] == ["s3", "sync"]:
    if os.path.isdir(local(args[2])):
        shutil.copytree(local(args[2]), local(args[3]), dirs_exist_ok=True)
elif args[:2] == ["s3", "ls"]:
    d = local(args[2])
    if not os.path.isdir(d):
        sys.exit(1)
    for name in sorted(os.listdir(d)):
        print(" " * 27 + "PRE " + name + "/")
else:
    sys.exit(2)
"""


def seconds_logged(path: str, pattern: str) -> float:
    """The seconds of the first line of ``path`` that matches ``pattern``
    (one group: the number)."""
    with open(path) as f:
        found = re.search(pattern, f.read())
    if found is None:
        raise RuntimeError(f"{path}: no line matches {pattern!r}")
    return float(found.group(1))


def remote_sync_run(dev, card: str, logs: str) -> dict:
    """Phase 15 (c): main --remote-sync s3://bucket/runs against AWS_STUB on
    PATH: MAIN_MODEL, 2 epochs of SAVE_STEPS_PER_EPOCH steps with one save
    (epoch_2), synced at startup and after the save; then a fresh log
    directory with --epochs 3 --resume latest lists the remote checkpoints,
    pulls epoch_2 and goes on at step 2 SAVE_STEPS_PER_EPOCH + 1. The sync
    seconds come from the runs' out.log."""
    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    stub_dir, root = os.path.join(logs, "awsbin"), os.path.join(logs, "s3")
    os.makedirs(stub_dir)
    os.makedirs(root)
    stub = os.path.join(stub_dir, "aws")
    with open(stub, "w") as f:
        f.write(AWS_STUB.format(python=sys.executable))
    os.chmod(stub, 0o755)
    saved = {k: os.environ.get(k) for k in ("PATH", "AWS_STUB_ROOT")}
    os.environ["PATH"] = stub_dir + os.pathsep + os.environ.get("PATH", "")
    os.environ["AWS_STUB_ROOT"] = root

    def argv(where, epochs, *extra):
        return ["--model", MAIN_MODEL, "--dataset-type", "synthetic", "--batch-size",
                str(TRAIN_BATCH), "--precision", "bf16", "--epochs", str(epochs),
                "--steps-per-epoch", str(SAVE_STEPS_PER_EPOCH), "--log-every-n-steps", "1",
                "--workers", "0", "--seed", "0", "--logs", os.path.join(logs, where),
                "--name", "remote", "--remote-sync", "s3://bucket/runs", *extra]

    res = {}
    try:
        first = argv("first", 2, "--save-frequency", "2")
        log(f"[15 remote] python -m colxlip_tpu_torch.main {' '.join(first)}")
        t0 = time.perf_counter()
        try:
            rc = entry.main(first)
        finally:
            setup_logging(None)
        res["first_s"] = time.perf_counter() - t0
        remote = os.path.join(root, "bucket", "runs", "remote")
        state = os.path.join(remote, "checkpoints", "epoch_2", "state.pt")
        if rc != 0 or not os.path.isfile(state) or not os.path.isfile(
                os.path.join(remote, "metrics.jsonl")):
            raise RuntimeError(f"phase 15 (c): rc {rc}; the remote holds "
                               f"{sorted(os.listdir(remote)) if os.path.isdir(remote) else None}")
        out_log = os.path.join(logs, "first", "remote", "out.log")
        res["startup_sync_s"] = seconds_logged(out_log, r"remote sync at startup took ([\d.]+) s")
        res["final_sync_s"] = seconds_logged(out_log, r"final remote sync took ([\d.]+) s")
        res["checkpoint_gib"] = os.path.getsize(state) / 2**30
        resume = argv("fresh", 3, "--save-frequency", "0", "--resume", "latest")
        try:
            rc = entry.main(resume)
        finally:
            setup_logging(None)
        base = os.path.join(logs, "fresh", "remote")
        with open(os.path.join(base, "metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f]
        res["pull_s"] = seconds_logged(os.path.join(base, "out.log"),
                                       r"pulled remote checkpoint \S+ in ([\d.]+) s")
        with open(os.path.join(base, "out.log")) as f:
            resumed = "(epoch 2)" in f.read()
        want = list(range(2 * SAVE_STEPS_PER_EPOCH + 1, 3 * SAVE_STEPS_PER_EPOCH + 1))
        if rc != 0 or not resumed or steps != want:
            raise RuntimeError(f"phase 15 (c) --resume latest: rc {rc}, resumed at epoch 2: "
                               f"{resumed}, steps {steps} (expected {want})")
        res["resumed_steps"] = steps
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for where in ("first", "fresh", "s3"):
            shutil.rmtree(os.path.join(logs, where), ignore_errors=True)
    log(f"[15 remote] --remote-sync s3://bucket/runs through a stand-in aws: the startup sync "
        f"{res['startup_sync_s']:.3f} s, the final sync after the last save "
        f"{res['final_sync_s']:.3f} s (one {res['checkpoint_gib']:.2f} GiB checkpoint, local "
        f"disk to local disk); a fresh log directory with --resume latest pulled epoch_2 in "
        f"{res['pull_s']:.3f} s and went on at step {steps[0]} ({card})")
    return res


def saves_phase(dev, card: str, train) -> dict:
    """Phase 15: --async-checkpoint (saves, their seconds apart, the resume)
    and --precision pure_bf16 (main, launches, the step's ms and peak)."""
    import torch

    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as logs:
        res["async_main"] = async_main_run(dev, card, logs)
        res["split"] = save_split(dev, card, logs)
        shutil.rmtree(os.path.join(logs, "async"))
        shutil.rmtree(os.path.join(logs, "split"))
        res["remote"] = remote_sync_run(dev, card, logs)

        recs, launches, peak, step = family_main(
            dev, card, "pure_bf16", MODEL, ["--precision", "pure_bf16"], 2 * TOWER_LAYERS,
            2 * TOWER_LAYERS, logs, other_launches={"maxsim_fwd": 1, "maxsim_bwd": 1},
            tag="[15 pure_bf16]")
    del step                      # main's model and AdamW state: not in the peaks below
    torch.cuda.empty_cache()
    images, texts = family_batch(MODEL, dev)
    cfg = TrainStepConfig(loss_type="colclip")
    steps = {}
    for name, dtype in (("pure_bf16", torch.bfloat16), ("bf16", torch.float32)):
        _, ms, step_peak = family_step_ms(dev, MODEL, cfg, images, texts, param_dtype=dtype)
        steps[name] = {"step_ms": ms, "img_per_s": FAMILY_BATCH / ms * 1e3, "peak_gib": step_peak}
    log(f"[15 pure_bf16] {MODEL} batch {FAMILY_BATCH}: loss "
        f"{recs[0]['total_loss']:.5f} -> {recs[-1]['total_loss']:.5f}; step "
        f"{steps['pure_bf16']['step_ms']:.2f} ms, peak {steps['pure_bf16']['peak_gib']:.2f} GiB; "
        f"fp32 parameters (bf16) in this phase {steps['bf16']['step_ms']:.2f} ms, "
        f"{steps['bf16']['peak_gib']:.2f} GiB; phase 6 {train['step_ms']:.2f} ms, "
        f"{train['peak_gib']:.2f} GiB ({card})")
    del images, texts
    torch.cuda.empty_cache()
    res["pure_bf16"] = {"losses": [r["total_loss"] for r in recs], "launches": launches,
                        "main_peak_gib": peak, **steps}
    log(f"[15 saves] phase 15 took {time.perf_counter() - t_phase:.1f} s ({card})")
    return res


def gspmd_counters():
    """Every kernel counter of the train step: attention, MaxSim, LayerNorm
    and MLP."""
    from colxlip_tpu_torch.ops import attention, maxsim

    return {"fused_attention_fwd": attention.LAUNCHES,
            "fused_attention_bwd": attention.BWD_LAUNCHES,
            "maxsim_fwd": maxsim.LAUNCHES, "maxsim_bwd": maxsim.BWD_LAUNCHES,
            **fused_counters()}


def gspmd_run(dev, card: str, ref_state, cfg, images, texts, mesh, steps: int,
              tag: str, keep: bool = False, model_name: "str | None" = None) -> dict:
    """``steps`` steps at learning rate 0 from ``ref_state``: the one-device
    step (``mesh`` None) or shard_state + make_train_step_gspmd(fsdp=True)
    on ``mesh``, the model built under the environment as it is. Returns the
    first step's metrics, gradients (this rank's shards: the whole at a mesh
    of one) and launches, the median ms of the later steps, the peak GiB,
    and (steps > 1) one profiled step's device ms and idle share; with
    ``keep`` also the model, the optimizer and the step."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.gspmd import local, make_train_step_gspmd, shard_state
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    model, _ = create_model(model_name or MODEL, dev, torch.bfloat16, seed=0)
    model.load_state_dict(ref_state)
    model.train()
    zero = const_lr(0.0, 0)
    if mesh is None:
        opt = create_optimizer(model, zero)
        step = make_train_step(model, opt, zero, cfg)
    else:
        shard_state(model, mesh, fsdp=True)
        opt = create_optimizer(model, zero)
        step = make_train_step_gspmd(model, opt, zero, cfg, mesh, fsdp=True)
    counters = gspmd_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"metrics": {k: float(v) for k, v in step(images, texts).items()}}
    torch.cuda.synchronize()
    out["launches"] = {name: c.value for name, c in counters.items()}
    out["grads"] = {k: local(p.grad).float().clone() for k, p in model.named_parameters()}
    secs = []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["ms"] = statistics.median(secs) * 1e3 if secs else float("nan")
    out["steps_ms"] = [t * 1e3 for t in secs]
    if steps > 1:
        events, wall_ms = profiled(lambda: step(images, texts))
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out["device_ms"], out["idle"] = device_ms, max(0.0, 1 - device_ms / wall_ms)
        log(f"{tag} profiled step: {device_ms:.1f} ms of kernels in {wall_ms:.1f} ms (device "
            f"idle {out['idle']:.1%}) ({card})")
    if keep:
        out["kept"] = (model, opt, step)
    else:
        del step, opt, model
        torch.cuda.empty_cache()
    return out


def gspmd_compare(tag: str, got: dict, want: dict, dtype: str, loss_tol: float,
                  vanishing: bool = False) -> list:
    """The sharded step's first step against the one-device step's: the
    losses within ``loss_tol`` relative, the gradients within phase 6's
    ``dtype`` bars; prints the readings and whether all is bit-equal.
    ``vanishing``: a tensor whose gradient is under VANISHING_GRAD of the
    step's largest norm is held by its difference instead (CoCa at random
    init, as ``compare_step`` holds it). Returns the failures."""
    loss_err = max(abs(got["metrics"][k] - want["metrics"][k])
                   / max(abs(want["metrics"][k]), 1e-30)
                   for k in want["metrics"] if k.endswith("loss"))
    want_g, small = want["grads"], {}
    if vanishing:
        largest = max(w.norm().item() for w in want_g.values())
        small = {k: (got["grads"][k] - w).norm().item() / largest for k, w in want_g.items()
                 if w.norm().item() < VANISHING_GRAD * largest}
        want_g = {k: w for k, w in want_g.items() if k not in small}
        log(f"{tag} {len(small)} tensors with a gradient under {VANISHING_GRAD} of the largest: "
            f"largest difference {max(small.values(), default=0.0):.3g} of it "
            f"(tol {VANISHING_GRAD})")
    cos_min, norm_err, equal, worst = grad_agreement(got["grads"], want_g)
    equal = equal and got["metrics"] == want["metrics"]
    cos_tol, norm_tol, _ = STEP_TOL[dtype]
    log(f"{tag} first step: " + " ".join(f"{k} {v:.6f}" for k, v in got["metrics"].items())
        + "; one device " + " ".join(f"{k} {v:.6f}" for k, v in want["metrics"].items()))
    log(f"{tag} max rel loss diff {loss_err:.3g} (tol {loss_tol}), lowest grad cosine "
        f"{cos_min:.7f} ({', '.join(f'{k} {v:.7f}' for k, v in worst.items())}; min "
        f"{cos_tol}), max rel grad-norm diff {norm_err:.3g} (tol {norm_tol}); metrics and "
        f"gradients {'bit-equal' if equal else 'not bit-equal'} to the one-device step")
    got["bit_equal"] = equal
    got.update(loss_rel_err=loss_err, grad_cos_min=cos_min, grad_norm_rel_err=norm_err)
    if (loss_err <= loss_tol and cos_min >= cos_tol and norm_err <= norm_tol
            and all(v <= VANISHING_GRAD for v in small.values())):
        return []
    return [f"{tag}: losses {loss_err:.3g}, cosine {cos_min:.7f}, norms {norm_err:.3g} outside "
            f"({loss_tol}, {cos_tol}, {norm_tol})"]


def gspmd_saves(dev, card: str, kept, mesh, saves) -> dict:
    """Phase 16 (c): (a)'s sharded state saved synchronously and in the
    background into $TMPDIR, restored into a fresh sharded state (bit-equal)
    and read whole (equal to the state)."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.gspmd import local, shard_state
    from colxlip_tpu_torch.training import checkpoint as ck
    from colxlip_tpu_torch.training.optim import create_optimizer

    model, opt, step = kept
    state = ck.sharded_train_state(model, opt, step.step)

    def shards(m, o):
        out = {f"param/{k}": local(p).detach() for k, p in m.named_parameters()}
        for k, p in m.named_parameters():
            out.update({f"{key}/{k}": local(v) for key, v in o.state[p].items()
                        if key != "step"})
        return out

    mine = shards(model, opt)
    res = {"state_gib": sum(t.numel() * t.element_size() for t in mine.values()) / 2**30}
    failures = []
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_path = ck.save_checkpoint_sharded(os.path.join(root, "sync"), state, epoch=1,
                                               name="gspmd")
        res["sync_save_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bg_path = ck.save_checkpoint_sharded(os.path.join(root, "bg"), state, epoch=1,
                                             name="gspmd", background=True)
        res["background_returned_s"] = time.perf_counter() - t0
        ck.wait_for_saves()
        res["background_total_s"] = time.perf_counter() - t0
        res["checkpoint_gib"] = sum(
            os.path.getsize(os.path.join(sync_path, f)) for f in os.listdir(sync_path)) / 2**30
        for label, path in (("sync", sync_path), ("background", bg_path)):
            fresh, _ = create_model(MODEL, dev, torch.bfloat16, seed=1)
            fresh.train()
            shard_state(fresh, mesh, fsdp=True)
            fresh_opt = create_optimizer(fresh, 0.0)
            t0 = time.perf_counter()
            restored = ck.restore_sharded_checkpoint(
                path, ck.sharded_train_state(fresh, fresh_opt, 0))
            got_step = ck.restore_sharded_train_state(restored["state"], fresh, fresh_opt)
            torch.cuda.synchronize()
            res[f"{label}_restore_s"] = time.perf_counter() - t0
            got = shards(fresh, fresh_opt)
            same = got.keys() == mine.keys() and all(torch.equal(got[k], mine[k]) for k in mine)
            res[f"{label}_restore_bit_equal"] = same and got_step == step.step
            if not res[f"{label}_restore_bit_equal"]:
                failures.append(f"the {label} sharded save restores other values")
            del fresh, fresh_opt, restored, got
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        whole = ck.load_native_checkpoint(sync_path)
        res["whole_read_s"] = time.perf_counter() - t0
        names = ck.optimizer_param_names(model, opt)
        osd = whole["state"]["optimizer"]
        same = whole["epoch"] == 1 and whole["state"]["step"] == step.step and all(
            torch.equal(whole["state"]["state_dict"][k].to(dev), mine[f"param/{k}"])
            for k in whole["state"]["state_dict"]) and all(
            torch.equal(osd["state"][i][key].to(dev), mine[f"{key}/{names[i]}"])
            for i in range(len(names)) for key in ("exp_avg", "exp_avg_sq"))
        res["whole_equal"] = same
        if not same:
            failures.append("load_native_checkpoint of the sharded save differs from the state")
        del whole, osd
    split = saves["split"]
    log(f"[16 gspmd] (c) {MODEL} sharded state ({res['state_gib']:.2f} GiB: weights and the "
        f"two AdamW moments; {res['checkpoint_gib']:.2f} GiB on disk): synchronous "
        f"save_checkpoint_sharded {res['sync_save_s']:.3f} s; in the background: the call "
        f"returns in {res['background_returned_s']:.3f} s, finished after "
        f"{res['background_total_s']:.3f} s; restores {res['sync_restore_s']:.3f} / "
        f"{res['background_restore_s']:.3f} s, bit-equal {res['sync_restore_bit_equal']} / "
        f"{res['background_restore_bit_equal']}; read whole {res['whole_read_s']:.3f} s, equal "
        f"to the state {res['whole_equal']}; phase 15's whole {MAIN_MODEL} save "
        f"{split['sync_save_s']:.3f} s synchronous, {split['host_snapshot_s']:.3f} s blocking "
        f"async ({card})")
    if failures:
        raise RuntimeError("phase 16 (c): " + "; ".join(failures))
    return res


def gspmd_refusal(dev) -> dict:
    """Phase 16 (d): main --fsdp at one process returns 1 before any model
    work, with the JAX entry point's words."""
    from colxlip_tpu_torch import main as main_mod

    want = ("--fsdp shards state over the data axis and needs a multi-device mesh with data "
            "size >= 2 (have 1 device(s), data axis 1)")
    build = main_mod.create_model_and_transforms

    def no_model(*a, **k):
        raise RuntimeError("phase 16 (d): main --fsdp reached the model at one process")

    with tempfile.TemporaryDirectory() as logs:
        main_mod.create_model_and_transforms = no_model
        try:
            rc = main_mod.main(["--model", MODEL, "--fsdp", "--dataset-type", "synthetic",
                                "--logs", logs, "--name", "fsdp1", "--device", str(dev)])
        finally:
            main_mod.create_model_and_transforms = build
        with open(os.path.join(logs, "fsdp1", "out.log")) as f:
            said = want in f.read()
    log(f"[16 gspmd] (d) main --fsdp at one process: rc {rc}, the JAX words in out.log: "
        f"{said}")
    if rc != 1 or not said:
        raise RuntimeError(f"phase 16 (d): main --fsdp at one process gave rc {rc}, message "
                           f"{'found' if said else 'missing'}")
    return {"rc": rc}


def gspmd_coca(dev, card: str, meshes) -> tuple:
    """Phase 16 (f): coca_ViT-B-32 (coca loss, bf16, FAMILY_BATCH, gather
    with gradient) under the TP plan on the 1 x 1 mesh and under FSDP on the
    mesh of one, each against the one-device step: the decoder's
    cross-attention (packed in_proj regrouped) and both attentional poolers
    (separate q / k / v) split over 'model'. Returns (the runs, the
    failures)."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

    model, _ = create_model(COCA_MODEL, dev, torch.bfloat16, seed=0)
    ref_state = copy.deepcopy(model.state_dict())
    del model
    images, texts = family_batch(COCA_MODEL, dev)
    cfg = TrainStepConfig(loss_type="coca", gather_with_grad=True)
    attn = {"fused_attention_fwd": 2 * COCA_LAYERS, "fused_attention_bwd": 2 * COCA_LAYERS,
            "maxsim_fwd": 0, "maxsim_bwd": 0, "fused_ln_fwd": 0, "fused_ln_bwd": 0,
            "fused_mlp_fwd": 0, "fused_mlp_bwd": 0}
    tag = "[16 gspmd coca]"
    one = gspmd_run(dev, card, ref_state, cfg, images, texts, None, GSPMD_STEPS, tag,
                    model_name=COCA_MODEL)
    log(f"{tag} one device: step {one['ms']:.2f} ms ({FAMILY_BATCH / one['ms'] * 1e3:.1f} img/s), "
        f"peak {one['peak_gib']:.2f} GiB, idle {one['idle']:.1%} ({card})")
    runs, failures = {"one": one}, []
    for name, label in (("tp", "the TP plan + FSDP, ('data', 'model') mesh of 1 x 1"),
                        ("fsdp", "FSDP, ('data',) mesh of one")):
        tag = f"[16 gspmd coca {name}]"
        run = gspmd_run(dev, card, ref_state, cfg, images, texts, meshes[name], GSPMD_STEPS,
                        tag, model_name=COCA_MODEL)
        failures += gspmd_compare(tag, run, one, "bfloat16", DIST_LOSS_TOL, vanishing=True)
        if run["launches"] != attn:
            failures.append(f"{tag}: launches {run['launches']}, expected {attn}")
        log(f"{tag} (f) {COCA_MODEL} under {label}: launches a step {run['launches']}; step "
            f"{run['ms']:.2f} ms at batch {FAMILY_BATCH} ({FAMILY_BATCH / run['ms'] * 1e3:.1f} "
            f"img/s; one device {one['ms']:.2f} ms), peak {run['peak_gib']:.2f} GiB, idle "
            f"{run['idle']:.1%} ({card})")
        runs[name] = run
    del ref_state, images, texts
    torch.cuda.empty_cache()
    return runs, failures


def gspmd_phase(dev, card: str, train, saves) -> dict:
    """Phase 16: sharded state under a NCCL process group of one (the
    module docstring's (a)-(d)). Every run is read before the phase fails."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.mesh import create_mesh
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

    t_phase = time.perf_counter()
    port = free_port()
    torch.cuda.set_device(dev)
    dist.init_process_group(DIST_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    res, failures = {}, []
    attn = {"fused_attention_fwd": 2 * TOWER_LAYERS, "fused_attention_bwd": 2 * TOWER_LAYERS,
            "maxsim_fwd": 1, "maxsim_bwd": 1}
    no_fused = {"fused_ln_fwd": 0, "fused_ln_bwd": 0, "fused_mlp_fwd": 0, "fused_mlp_bwd": 0}
    with_fused = {k: STEP_LAUNCHES["fused_ln" if "ln" in k else "fused_mlp"] for k in no_fused}
    try:
        model, cfg_m = create_model(MODEL, dev, torch.bfloat16, seed=0)
        ref_state = copy.deepcopy(model.state_dict())
        del model
        images, texts = synthetic_batch(TRAIN_BATCH, cfg_m.vision_cfg.image_size,
                                        cfg_m.text_cfg.context_length, seed=12)
        images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
        cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero",
                              gather_with_grad=True)
        one = gspmd_run(dev, card, ref_state, cfg, images, texts, None, 1, "[16 gspmd]")
        meshes = {"fsdp": create_mesh(1),
                  "tp": init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))}
        for name, label in (("fsdp", "(a) FSDP, ('data',) mesh of one"),
                            ("tp", "(b) TP plan + FSDP, ('data', 'model') mesh of 1 x 1")):
            tag = f"[16 gspmd {name}]"
            run = gspmd_run(dev, card, ref_state, cfg, images, texts, meshes[name],
                            GSPMD_STEPS, tag, keep=name == "fsdp")
            failures += gspmd_compare(tag, run, one, "bfloat16", DIST_LOSS_TOL)
            if run["launches"] != {**attn, **no_fused}:
                failures.append(f"{tag}: launches {run['launches']}")
            log(f"{tag} {label}: launches a step {run['launches']}; step {run['ms']:.2f} ms at "
                f"batch {TRAIN_BATCH} (steps 2-{GSPMD_STEPS}: "
                f"{', '.join(f'{t:.2f}' for t in run['steps_ms'])}; "
                f"{TRAIN_BATCH / run['ms'] * 1e3:.1f} img/s), peak "
                f"{run['peak_gib']:.2f} GiB, idle {run['idle']:.1%}; phase 6 "
                f"{train['step_ms']:.2f} ms ({TRAIN_BATCH / train['step_ms'] * 1e3:.1f} img/s), "
                f"{train['peak_gib']:.2f} GiB ({card})")
            res[name] = run
        tag = "[16 gspmd tp fused]"
        with fused_towers():
            one_fused = gspmd_run(dev, card, ref_state, cfg, images, texts, None, 1, tag)
            run = gspmd_run(dev, card, ref_state, cfg, images, texts, meshes["tp"], GSPMD_STEPS,
                            tag)
        failures += gspmd_compare(tag, run, one_fused, "bfloat16", STEP_TOL["bfloat16"][2])
        if run["launches"] != {**attn, **with_fused} or one_fused["launches"] != run["launches"]:
            failures.append(f"{tag}: launches {run['launches']}, one device "
                            f"{one_fused['launches']}")
        log(f"{tag} (b) under COLXLIP_LN_IMPL=fused COLXLIP_MLP_IMPL=fused: launches a step "
            f"{run['launches']}; step {run['ms']:.2f} ms (steps 2-{GSPMD_STEPS}: "
            f"{', '.join(f'{t:.2f}' for t in run['steps_ms'])}; "
            f"{TRAIN_BATCH / run['ms'] * 1e3:.1f} img/s), peak {run['peak_gib']:.2f} GiB, idle {run['idle']:.1%} ({card})")
        res["tp_fused"] = run
        del one_fused
        tag = "[16 gspmd tp int8]"
        with fused_towers(("COLXLIP_MLP_INT8",), "fwd"):
            one_int8 = gspmd_run(dev, card, ref_state, cfg, images, texts, None, 1, tag)
            run = gspmd_run(dev, card, ref_state, cfg, images, texts, meshes["tp"], GSPMD_STEPS,
                            tag)
        failures += gspmd_compare(tag, run, one_int8, "bfloat16", DIST_LOSS_TOL)
        if run["launches"] != {**attn, **no_fused} or one_int8["launches"] != run["launches"]:
            failures.append(f"{tag}: launches {run['launches']}, one device "
                            f"{one_int8['launches']}")
        log(f"{tag} (e) the TP plan under COLXLIP_MLP_INT8=fwd (c_proj: the model group's "
            f"scales, int32 sums): launches a step {run['launches']}; step {run['ms']:.2f} ms "
            f"({TRAIN_BATCH / run['ms'] * 1e3:.1f} img/s), peak {run['peak_gib']:.2f} GiB, idle "
            f"{run['idle']:.1%} ({card})")
        res["tp_int8"] = run
        del one_int8, ref_state, images, texts
        coca, coca_failures = gspmd_coca(dev, card, meshes)
        res["coca"] = coca
        failures += coca_failures
        kept = res["fsdp"].pop("kept")
        res["saves"] = gspmd_saves(dev, card, kept, meshes["fsdp"], saves)
        del kept
        torch.cuda.empty_cache()
        res["refusal"] = gspmd_refusal(dev)
    finally:
        dist.destroy_process_group()
    for run in (res.get("fsdp"), res.get("tp"), res.get("tp_fused"), res.get("tp_int8"),
                *res.get("coca", {}).values()):
        if run is not None:
            run.pop("grads", None)
    log(f"[16 gspmd] phase 16 took {time.perf_counter() - t_phase:.1f} s ({card})")
    if failures:
        raise RuntimeError("phase 16: " + "; ".join(failures))
    return res


def aot_phase(dev, card: str) -> dict:
    """Phase 17: MODEL's towers exported on the card with a symbolic batch
    (serving/aot.py on torch.export), saved, loaded back without the model
    code, and held against the live model at AOT_BATCHES within phase 4's
    encode bars; img/s and txt/s at the last batch beside the live model's;
    the export seconds and the bundle's bytes; kernel #1 launches 0 times
    inside the bundle (its attention is SDPA, as the JAX dispatch leaves the
    Pallas kernel under symbolic dims) where the live model launches it."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention
    from colxlip_tpu_torch.serving import aot

    t_phase = time.perf_counter()
    model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    n = max(AOT_BATCHES)
    images, texts = synthetic_batch(n, cfg.vision_cfg.image_size, cfg.text_cfg.context_length,
                                    seed=17)
    images, texts = torch.from_numpy(images).to(dev), torch.from_numpy(texts).to(dev)
    res = {"batches": {}}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        meta = aot.save_aot_bundle(out, model, cfg, model_name=MODEL)
        res["export_s"] = time.perf_counter() - t0
        res["bytes"] = meta["bytes"]
        t0 = time.perf_counter()
        bundle = aot.load_aot_bundle(out, device=dev)
        res["load_s"] = time.perf_counter() - t0
    bundle_launches, live_launches, failures = 0, 0, []
    for b in AOT_BATCHES:
        attention.LAUNCHES.reset()
        got = bundle.encode_image(images[:b]) + bundle.encode_text(texts[:b])
        torch.cuda.synchronize()
        bundle_launches += attention.LAUNCHES.value
        attention.LAUNCHES.reset()
        with torch.inference_mode():
            want = (model.encode_image(images[:b], normalize=True)
                    + model.encode_text(texts[:b], normalize=True))
        torch.cuda.synchronize()
        live_launches += attention.LAUNCHES.value
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        off = max(((1.0 - torch.nn.functional.cosine_similarity(
            g.float(), w.float(), dim=-1)) * (w.float().norm(dim=-1) > 0.5)).max().item()
            for g, w in zip(got, want))
        res["batches"][b] = {"max_abs_err": err, "one_minus_cosine": off}
        log(f"[17 aot] batch {b}: the bundle's four outputs "
            f"{[tuple(g.shape) for g in got]} vs the live model: max_abs_err {err:.3g} (tol "
            f"{ENCODE_TOL}), largest 1 - cosine of a row {off:.3g} (tol {ENCODE_COSINE_TOL})")
        if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL
                and all(torch.isfinite(g).all() for g in got)):
            failures.append(f"batch {b}: max_abs_err {err}, 1 - cosine {off}")
    log(f"[17 aot] kernel #1 launches inside the bundle: {bundle_launches} over "
        f"{len(AOT_BATCHES)} image and text encodes (the live model: {live_launches})")
    if bundle_launches != 0 or live_launches < 1:
        failures.append(f"#1 launched {bundle_launches} times in the bundle, {live_launches} by "
                        "the live model")
    rates = {}
    for kind in ("image", "text"):
        batch = images if kind == "image" else texts
        fn = getattr(bundle, f"encode_{kind}")
        live = getattr(model, f"encode_{kind}")
        def live_encode():
            with torch.inference_mode():
                return live(batch, normalize=True)

        rates[kind] = (cuda_ms(lambda: fn(batch), 10), cuda_ms(live_encode, 10))
        unit = "img/s" if kind == "image" else "txt/s"
        log(f"[17 aot] encode {kind} batch {n} on the card: bundle {rates[kind][0]:.3f} ms = "
            f"{n / rates[kind][0] * 1e3:.1f} {unit}, live model {rates[kind][1]:.3f} ms = "
            f"{n / rates[kind][1] * 1e3:.1f} {unit} ({card})")
    res.update(bundle_launches=bundle_launches, live_launches=live_launches,
               image_ms=rates["image"][0], image_live_ms=rates["image"][1],
               text_ms=rates["text"][0], text_live_ms=rates["text"][1])
    log(f"[17 aot] {MODEL} exported in {res['export_s']:.1f} s, loaded in {res['load_s']:.1f} s; "
        f"bundle files {res['bytes']} bytes; phase 17 took {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    del bundle, model, images, texts
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("phase 17: " + "; ".join(failures))
    return res


def main() -> int:
    import torch

    # ---- phase 1: device -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from colxlip_tpu_torch.ops import attention, build, fused_ce, maxsim
    from colxlip_tpu_torch.serving.server import (
        ColXLIPService, disable_tf32, make_server)

    disable_tf32()  # fp32 matmuls in full fp32 (the plain versions, scores)
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # ---- phase 2: build --------------------------------------------------
    usage = {}
    usage_thread = threading.Thread(
        target=lambda: usage.update(build.resource_usage(
            ["fused_attention", "fused_attention_bwd", "maxsim", "maxsim_bwd", "fused_mlp",
             "fused_ce", "fused_ln"])),
        daemon=True)
    usage_thread.start()
    kernels = build.load_kernels()
    log(f"[2 build] {kernels.build_seconds:.1f} s nvcc {' '.join(build.NVCC_FLAGS)}"
        f" -> {kernels.path.relative_to(build.PKG_DIR.parent)}")

    # ---- phase 3: each kernel against its plain version -------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    for rows in (64, 5):
        a, b = (torch.randn(64, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        got_abt, got_pb, got_tn = attention.mma_tile_check(a, b, rows)
        torch.cuda.synchronize()
        a32, b32 = a.float(), b.float()
        a32[rows:], b32[rows:] = 0, 0
        want_abt = a32 @ b32.T
        want_pb = want_abt.bfloat16().float() @ b32
        errs = ((got_abt - want_abt).abs().max().item(),
                ((got_pb - want_pb).abs().max() / want_pb.abs().max()).item(),
                (got_tn - a32.T @ b32).abs().max().item())
        log(f"[3 kernels] mma tile 64 x 64 x 64 ({rows} live rows) vs torch.matmul: A.B^T "
            f"max_abs_err {errs[0]:.3g} (tol {MMA_TILE_TOL[0]}); bf16(A.B^T).B max_abs_err / "
            f"max|.| {errs[1]:.3g} (tol {MMA_TILE_TOL[1]}); A^T.B (k-major tiles) max_abs_err "
            f"{errs[2]:.3g} (tol {MMA_TILE_TOL[0]})")
        if not (errs[0] <= MMA_TILE_TOL[0] and errs[1] <= MMA_TILE_TOL[1]
                and errs[2] <= MMA_TILE_TOL[0]):
            raise RuntimeError(f"the tensor-core tile code disagrees with torch.matmul: {errs}")
    attn_cases = [
        # name, B, N, H, D, causal, dtype
        ("vision", 64, 197, 12, 64, False, torch.bfloat16),
        ("text", 64, 77, 8, 64, True, torch.bfloat16),
        ("tiny-d32", 8, 32, 4, 32, True, torch.bfloat16),
        ("vision-fp32", 64, 197, 12, 64, False, torch.float32),
        *((name, b, n, h, d, causal, getattr(torch, dtypes[0]))
          for name, b, n, h, d, causal, dtypes in ATTN_EXTRA_CASES),
    ]
    attn_inputs, attn_err = {}, 0.0
    with torch.inference_mode():
        for name, b, n, h, d, causal, dtype in attn_cases:
            qkv = torch.randn(b, n, 3 * h * d, generator=gen).to(dev, dtype)
            got = attention.fused_mha_packed(qkv, h, causal)
            want = attention.fused_mha_plain(qkv, h, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = ATTN_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] attention {name} B={b} N={n} H={h} D={d} "
                f"causal={causal} {dtype}: max_abs_err {err:.3g} (tol {tol})")
            if not err <= tol:
                raise RuntimeError(f"attention {name}: {err} > {tol}")
            attn_err = max(attn_err, err)
            if name in ("vision", "text", "tiny-d32", "vision-fp32"):
                attn_inputs[name] = (qkv, h, causal)

        m = k = 64
        lt, li, d = 77, 196, 512
        t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
        eot = torch.randint(3, lt, (m,), generator=gen)
        keep = torch.arange(lt)[None, :] < eot[:, None]
        t = (t * keep[:, :, None]).to(dev)           # zero text rows past EOT
        img = torch.nn.functional.normalize(
            torch.randn(k, li, d, generator=gen), dim=-1).to(dev)
        text_mask = keep.float().to(dev)
        # the serving shape in fp32 (/v1/score); bf16 at the main path's shape
        # and the long token counts follow in phase 3b
        serving_err = max(check_maxsim_forward(t, img, mode, text_mask, "serving")
                          for mode in ("nonzero", "plain", "valid"))
    bwd_err, bwd_inputs = check_backward_kernels(dev, gen)
    ce_err, ce_inputs_by_m = check_ce_kernels(dev, gen)
    fused_err_by_kernel, fused_inputs = check_fused_kernels(dev, gen)
    quant_err, quant_inputs = check_quantizer(dev, gen)

    # ---- phase 4: the serving slice over HTTP ------------------------------
    t0 = time.perf_counter()
    svc = ColXLIPService(MODEL, device=dev, max_batch=MAX_BATCH, seed=0)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    log(f"[4 slice] {MODEL} random init (seed 0) on {dev}, bf16 compute, "
        f"built in {time.perf_counter() - t0:.1f} s; serving on port {port}")
    rng = np.random.default_rng(0)
    captions = ["a photo of a cat sleeping on a red sofa",
                "two dogs running on the beach at sunset",
                "a bowl of ramen with an egg"]
    images = [jpeg_b64(rng, int(rng.integers(200, 320)), int(rng.integers(200, 320)))
              for _ in range(3)]
    wide_texts = [f"a photo of item number {i} on a wooden table" for i in range(MAX_BATCH)]
    wide_images = [jpeg_b64(rng, 240, 300) for _ in range(MAX_BATCH)]
    requests = [
        ("/healthz", None),
        ("/v1/embed/text", {"texts": captions, "return_tokens": True}),
        ("/v1/embed/image", {"images_b64": images}),
        ("/v1/score", {"texts": captions, "images_b64": images, "scoring": "maxsim"}),
        ("/v1/score", {"texts": captions, "images_b64": images, "scoring": "mixed"}),
        ("/v1/score", {"texts": wide_texts, "images_b64": wide_images,
                       "scoring": "maxsim"}),
    ]
    try:
        unused = fused_counters()
        for counter in (attention.LAUNCHES, attention.BWD_LAUNCHES, maxsim.LAUNCHES,
                        maxsim.BWD_LAUNCHES, *unused.values()):
            counter.reset()
        results = [http(port, path, body) for path, body in requests]
        torch.cuda.synchronize()
        check_default_path(unused, "phase 4")
        launches = {"fused_attention": attention.LAUNCHES.value,
                    "maxsim": maxsim.LAUNCHES.value}
        log(f"[4 slice] {len(requests)} requests: "
            + ", ".join(f"{p} {s * 1e3:.0f} ms" for (p, _), (_, s) in zip(requests, results))
            + f" | kernel launches {launches}")
        if min(launches.values()) < 1:
            raise RuntimeError(f"a kernel of the path was never launched: {launches}")

        health = results[0][0]
        if health["status"] != "ok" or health["embed_dim"] != 512:
            raise RuntimeError(f"/healthz: {health}")
        for i, shape in ((1, (3, 512)), (2, (3, 512))):
            emb = np.asarray(results[i][0]["embeddings"], np.float32)
            norms = np.linalg.norm(emb, axis=-1)
            if emb.shape != shape or not np.isfinite(emb).all() or \
                    np.abs(norms - 1).max() > 1e-2:
                raise RuntimeError(f"{requests[i][0]}: shape {emb.shape}, "
                                   f"norms {norms}")
        # token features: unit norm before EOT (at and after it they are the
        # token head's response to a zeroed input, all-zero at random init)
        tok = np.asarray(results[1][0]["token_embeddings"], np.float32)
        eot = svc.tokenize(captions).argmax(axis=-1)
        before = np.arange(tok.shape[1])[None, :] < eot[:, None]
        if tok.shape != (3, 77, 512) or not np.isfinite(tok).all() or \
                np.abs(np.linalg.norm(tok, axis=-1)[before] - 1).max() > 1e-2:
            raise RuntimeError(f"text token embeddings: shape {tok.shape}")

        # /v1/score against the plain path (plain attention in the towers,
        # plain MaxSim, same weights, same inputs, same device)
        scale = svc.logit_scale
        score_err = 0.0
        for i in (3, 4, 5):
            body = requests[i][1]
            sim = np.asarray(results[i][0]["similarity"], np.float32)
            n_img, n_txt = len(body["images_b64"]), len(body["texts"])
            if sim.shape != (n_img, n_txt) or not np.isfinite(sim).all():
                raise RuntimeError(f"/v1/score: shape {sim.shape}")
            with plain_versions(), torch.inference_mode():
                txt = svc.engine.run("text", svc.tokenize(body["texts"]))
                im = svc.engine.run("image", svc.decode_images(body["images_b64"]))
                token = scale * maxsim.maxsim_plain(
                    txt[1].float(), im[1].float(), mask_mode=svc.mask_mode).T
                if body["scoring"] == "mixed":
                    glob = scale * (im[0].float() @ txt[0].float().T)
                    token = svc.alpha * glob + (1 - svc.alpha) * token
                want = token.cpu().numpy()
            err = float(np.abs(sim - want).max())
            score_err = max(score_err, err)
            tol = SCORE_TOL_PER_UNIT_SCALE * scale
            log(f"[4 slice] /v1/score {body['scoring']} {n_img}x{n_txt} vs plain "
                f"path: max_abs_err {err:.3g} (tol {tol:.3g} = "
                f"{SCORE_TOL_PER_UNIT_SCALE} x logit_scale {scale:.4f}); "
                f"|score| max {np.abs(want).max():.3g}")
            if not err <= tol:
                raise RuntimeError(f"/v1/score {body['scoring']}: {err} > {tol}")

        # ---- phase 5: timings --------------------------------------------
        timing = {}
        with torch.inference_mode():
            for name, (qkv, h, causal) in attn_inputs.items():
                ker = cuda_ms(lambda: attention.fused_mha_packed(qkv, h, causal), 20)
                plain = cuda_ms(lambda: attention.fused_mha_plain(qkv, h, causal), 20)
                timing[f"attention/{name}"] = (ker, plain)
            for mode in ("nonzero", "plain", "valid"):
                ker = cuda_ms(lambda: maxsim.maxsim(t, img, mask_mode=mode,
                                                    text_mask=text_mask), 10)
                plain = cuda_ms(lambda: maxsim.maxsim_plain(
                    t, img, mask_mode=mode, text_mask=text_mask), 10)
                timing[f"maxsim/{mode}"] = (ker, plain)
            # forward kernels at the training shapes (batch 256, bf16)
            for name in ("vision", "text"):
                qkv, _, h, causal = bwd_inputs[f"attention_bwd/{name}"]
                timing[f"attention/{name}-train"] = (
                    cuda_ms(lambda: attention.fused_mha_packed(qkv, h, causal), 10),
                    cuda_ms(lambda: attention.fused_mha_plain(qkv, h, causal), 10))
            tt, ii, g, tmask = bwd_inputs["maxsim_bwd"]
            timing["maxsim/nonzero-train"] = (
                cuda_ms(lambda: maxsim.maxsim(tt, ii), 5),
                cuda_ms(lambda: maxsim.maxsim_plain(tt, ii), 5))
        # backward kernels at the training shapes (batch 256, bf16)
        for name in ("vision", "text", "tiny-d32"):
            qkv, dout, h, causal = bwd_inputs[f"attention_bwd/{name}"]
            timing[f"attention_bwd/{name}"] = (
                cuda_ms(lambda: attention._launch_bwd(qkv, dout, h, causal), 10),
                cuda_ms(lambda: attention.fused_mha_bwd_plain(qkv, dout, h, causal), 10))
        timing["maxsim_bwd/nonzero"] = (
            cuda_ms(lambda: maxsim._launch_bwd(tt, ii, g, "nonzero", None), 5),
            cuda_ms(lambda: maxsim.maxsim_bwd_plain(tt, ii, g), 5))
        for key, (ker, plain) in timing.items():
            log(f"[5 timing] {key}: kernel {ker:.4f} ms, plain {plain:.4f} ms "
                f"({card})")
        maxsim_passes = maxsim_pass_ms(tt, ii, g)
        log(f"[5 timing] maxsim passes, bf16 {TRAIN_BATCH} x {TRAIN_BATCH} (device ms a call, "
            f"torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in maxsim_passes.items())
            + f" ({card})")
        timing.update(time_ce_kernels(ce_inputs_by_m, card))
        timing.update(time_fused_kernels(fused_inputs, card))
        mlp_case_bounds = {case: mlp_bounds(*fused_inputs[f"mlp/{case}"][:2])
                           for case, *_ in MLP_CASES}
        wide = f"{MLP_FP32_WIDE[0]}-fp32"
        mlp_case_bounds[wide] = mlp_bounds(*fused_inputs[f"mlp32/{MLP_FP32_WIDE[0]}"][:2])
        quant_timing, quant_bounds = time_quantizer(quant_inputs, card)
        timing.update(quant_timing)
        qkv, h, causal = attn_inputs["vision"]
        sdpa_fwd, _ = time_library_attention(qkv, None, h, causal)
        sdpa_train = time_library_attention(*bwd_inputs["attention_bwd/vision"])
        log(f"[5 timing] F.scaled_dot_product_attention, vision shape: forward B=64 "
            f"{sdpa_fwd:.4f} ms; B={TRAIN_BATCH} forward {sdpa_train[0]:.4f} ms, backward "
            f"{sdpa_train[1]:.4f} ms ({card})")

        # the same two kernels at ViT-L/14's shape (257 tokens, 16 heads), batch 64
        qkv_l = torch.randn(MAX_BATCH, 257, 3 * 16 * 64, generator=gen).to(dev, torch.bfloat16)
        dout_l = torch.randn(MAX_BATCH, 257, 16 * 64, generator=gen).to(dev, torch.bfloat16)
        with torch.inference_mode():
            vit_l_fwd = (cuda_ms(lambda: attention.fused_mha_packed(qkv_l, 16, False), 10),
                         cuda_ms(lambda: attention.fused_mha_plain(qkv_l, 16, False), 10))
        vit_l_bwd = (cuda_ms(lambda: attention._launch_bwd(qkv_l, dout_l, 16, False), 10),
                     cuda_ms(lambda: attention.fused_mha_bwd_plain(qkv_l, dout_l, 16, False), 10))
        sdpa_l = time_library_attention(qkv_l, dout_l, 16, False)
        vit_l_bounds = attention_bounds(qkv_l, qkv_l)
        log(f"[5 timing] attention at the ViT-L/14 shape B={MAX_BATCH} N=257 H=16 D=64 bf16: "
            f"forward kernel {vit_l_fwd[0]:.4f} ms, plain {vit_l_fwd[1]:.4f} ms, SDPA "
            f"{sdpa_l[0]:.4f} ms, bound {vit_l_bounds['fused_attention_fwd'][0]:.5f} ms; backward "
            f"kernel {vit_l_bwd[0]:.4f} ms, plain {vit_l_bwd[1]:.4f} ms, SDPA {sdpa_l[1]:.4f} ms, "
            f"bound {vit_l_bounds['fused_attention_bwd'][0]:.5f} ms ({card})")
        del qkv_l, dout_l
        usage_thread.join(timeout=300)
        for name, (regs, stack, stores, loads) in sorted(usage.items()):
            log(f"[5 timing] ptxas {name}: {regs} registers, {stack} bytes stack, spills "
                f"{stores} bytes stored / {loads} loaded")
        if not usage:
            raise RuntimeError("nvcc -Xptxas -v reported no kernel of the attention sources")

        bounds = kernel_bounds(attn_inputs["vision"][0], bwd_inputs["attention_bwd/vision"][0],
                               attn_inputs["vision"][1], (tt, ii), (tt, ii),
                               ce_inputs_by_m[TRAIN_BATCH][:2], fused_inputs["ln/vision"][0],
                               *fused_inputs["mlp/vision"][:2])
        bounds["maxsim_fwd/serving"] = maxsim_bound(t, img, False)
        text_qkv = bwd_inputs["attention_bwd/text"][0]
        text_bounds = attention_bounds(text_qkv, text_qkv, causal=True)
        bounds.update({f"{k}/text": v for k, v in text_bounds.items()})
        vision_qkv = bwd_inputs["attention_bwd/vision"][0]
        bounds["fused_attention_fwd/vision-train"] = attention_bounds(
            vision_qkv, vision_qkv)["fused_attention_fwd"]
        sdpa_text = time_library_attention(*bwd_inputs["attention_bwd/text"])
        log(f"[5 timing] F.scaled_dot_product_attention, text shape B={TRAIN_BATCH} causal: "
            f"forward {sdpa_text[0]:.4f} ms, backward {sdpa_text[1]:.4f} ms ({card})")
        ln_fwd_cases = {}
        for case in ("vision", "text", "token-head", "vit-l"):
            x = fused_inputs[f"ln/{case}"][0]
            rows, d = x.numel() // x.shape[-1], x.shape[-1]
            ker, plain, lib = timing[f"fused_ln_fwd/{case}"]
            ln_fwd_cases[case] = {
                "rows": rows, "d": d, "ms": ker, "plain_ms": plain, "library_ms": lib,
                "bound_ms": bound_ms(2 * rows * d * x.element_size(), 8 * rows * d,
                                     "bfloat16")[0]}
            log(f"[5 timing] fused_ln_fwd/{case} {rows} x {d} bf16: kernel {ker:.4f} ms, "
                f"F.layer_norm {lib:.4f} ms, bound {ln_fwd_cases[case]['bound_ms']:.5f} ms "
                f"(bytes) ({card})")
        for name, (ms, by) in bounds.items():
            log(f"[5 timing] bound {name}: {ms:.5f} ms, by {by} (H100 SXM: 3.35 TB/s, "
                f"989 TFLOP/s bf16, 67 TFLOP/s fp32)")

        img_batch = svc.decode_images(wide_images)
        txt_batch = svc.tokenize(wide_texts)
        encode_ms = {}
        for kind, batch in (("image", img_batch), ("text", txt_batch)):
            ms = cuda_ms(lambda: svc.engine.run(kind, batch), 10)
            encode_ms["vision" if kind == "image" else "text"] = ms
            unit = "img/s" if kind == "image" else "txt/s"
            log(f"[5 timing] encode {kind} batch {MAX_BATCH} (host batch -> "
                f"normalized features on device): {ms:.3f} ms = "
                f"{MAX_BATCH / ms * 1e3:.1f} {unit} ({card})")
        lat = {}
        for _ in range(5):
            for path, body in requests[1:5]:
                key = path + ("" if body.get("scoring") is None else f"[{body['scoring']}]")
                lat.setdefault(key, []).append(http(port, path, body)[1])
        lat["/v1/score[maxsim] 64x64"] = [http(port, *requests[5])[1] for _ in range(3)]
        for key, secs in lat.items():
            log(f"[5 timing] request {key}: median {statistics.median(secs) * 1e3:.1f} ms "
                f"over {len(secs)} ({card})")
        log(f"[5 timing] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        httpd.shutdown()
        svc.stop()
        server.join(timeout=30)
    ce_sizes = list(ce_inputs_by_m)
    del svc, bwd_inputs, ce_inputs_by_m, fused_inputs
    torch.cuda.empty_cache()

    # ---- phase 6: the train slice -----------------------------------------
    train = train_phase(dev, card)
    vit_l = vit_l_phase(dev, card)
    ln_only = ln_only_phase(dev, card, train)

    with tempfile.TemporaryDirectory() as eval_dir:
        t0 = time.perf_counter()
        flickr = write_flickr_suite(eval_dir)
        log(f"[7 main] wrote {flickr[2]} seeded JPEGs at the paths of the Flickr30k val "
            f"annotations ({flickr[1]} captions) in {time.perf_counter() - t0:.1f} s")

        # ---- phase 7: the training entry point ------------------------------
        trainer = main_phase(dev, card, *flickr)

        # ---- phase 8: the towers through the LayerNorm and MLP kernels ------
        fused = fused_phase(dev, card, train)
        vit_l_fused = vit_l_fused_phase(dev, card, vit_l)

        # ---- phase 9: the int8 slice and /v1/search --------------------------
        int8 = int8_phase(dev, card, train, encode_ms)

        # ---- phase 10: retrieval and zero-shot eval ---------------------------
        evaluation = eval_phase(dev, card, *flickr, eval_dir)

    # ---- phase 11: the tar path through main ------------------------------
    tar = tar_phase(dev, card, train["losses"][0])

    # ---- phase 12: data parallelism under a process group of one ----------
    data_parallel = dist_phase(dev, card, train)

    # ---- phase 13: SigLIP, distillation, CoCa training and captioning -----
    families = families_phase(dev, card)

    # ---- phase 14: one device's share of the pod recipes --------------------
    pod = pod_phase(dev, card, train)

    # ---- phase 15: --async-checkpoint and --precision pure_bf16 through main -
    saves = saves_phase(dev, card, train)

    # ---- phase 16: sharded state under a process group of one ---------------
    sharded = gspmd_phase(dev, card, train, saves)

    # ---- phase 17: the serving bundle on torch.export -----------------------
    bundle = aot_phase(dev, card)

    tl, ml, fl = train["launches"], trainer["launches"], fused["launches"]
    ce_ms = {k: timing[f"fused_ce_{k}/{TRAIN_BATCH}"] for k in ("fwd", "bwd_da", "bwd_db")}
    attn_fwd = (tl["fused_attention_fwd"], attn_err, timing["attention/vision"],
                bounds["fused_attention_fwd"], sdpa_fwd)
    attn_bwd = (tl["fused_attention_bwd"], bwd_err["attention_bwd"],
                timing["attention_bwd/vision"], bounds["fused_attention_bwd"], sdpa_train[1])
    rows = [
        ("fused_attention_fwd", "colxlip_tpu_torch/csrc/fused_attention.cu",
         "colxlip_tpu/ops/fused_attention.py:103", *attn_fwd),
        ("fused_attention_bwd", "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "colxlip_tpu/ops/fused_attention.py:115", *attn_bwd),
        # the TPU's head-pair grid variants are the same functions: the CUDA
        # kernels grid over heads already and serve them too
        ("fused_attention_fwd_heads", "colxlip_tpu_torch/csrc/fused_attention.cu",
         "colxlip_tpu/ops/fused_attention.py:193", *attn_fwd),
        ("fused_attention_bwd_heads", "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "colxlip_tpu/ops/fused_attention.py:222", *attn_bwd),
        # the main path's shape: bf16, 256 x 256 (the serving reading is below)
        ("maxsim_fwd", "colxlip_tpu_torch/csrc/maxsim.cu",
         "colxlip_tpu/ops/maxsim_pallas.py:112", tl["maxsim_fwd"],
         max(serving_err, bwd_err["maxsim_fwd"]), timing["maxsim/nonzero-train"],
         bounds["maxsim_fwd"], None),
        ("maxsim_bwd", "colxlip_tpu_torch/csrc/maxsim_bwd.cu",
         "colxlip_tpu/ops/maxsim_pallas.py:244", tl["maxsim_bwd"], bwd_err["maxsim_bwd"],
         timing["maxsim_bwd/nonzero"], bounds["maxsim_bwd"], None),
        ("fused_ce_fwd", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:45", ml["fused_ce_fwd"], ce_err["fused_ce_fwd"],
         ce_ms["fwd"], bounds["fused_ce_fwd"], None),
        ("fused_ce_bwd_da", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:122", ml["fused_ce_bwd_da"], ce_err["fused_ce_bwd_da"],
         ce_ms["bwd_da"], bounds["fused_ce_bwd_da"], None),
        ("fused_ce_bwd_db", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:152", ml["fused_ce_bwd_db"], ce_err["fused_ce_bwd_db"],
         ce_ms["bwd_db"], bounds["fused_ce_bwd_db"], None),
    ]
    # the LayerNorm kernels stand beside F.layer_norm; the MLP has no one call
    # (its three-call path is under "mlp_three_calls_ms")
    for name, source, replaces, has_library in (
            ("fused_ln_fwd", "fused_ln.cu", "fused_ln.py:58", True),
            ("fused_ln_bwd", "fused_ln.cu", "fused_ln.py:68", True),
            ("fused_mlp_fwd", "fused_mlp.cu", "fused_mlp.py:182", False),
            ("fused_mlp_bwd", "fused_mlp.cu", "fused_mlp.py:198", False)):
        ker, plain, lib = timing[f"{name}/vision"]
        rows.append((name, f"colxlip_tpu_torch/csrc/{source}", f"colxlip_tpu/ops/{replaces}",
                     fl[name], fused_err_by_kernel[name], (ker, plain), bounds[name],
                     lib if has_library else None))
    quant_key = "768x3072/float32"
    rows.append(("quantize_int8", "colxlip_tpu_torch/csrc/quantize_int8.cu",
                 "colxlip_tpu/ops/quantization.py:52", int8["quant_launches"], quant_err,
                 timing[f"quantize_int8/{quant_key}"][:2], quant_bounds[quant_key], None))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}
        for name, source, replaces, n_launches, err, (ms, plain_ms), bound, library_ms in rows],
        "launches_serving": launches, "launches_main": ml, "launches_fused": fl,
        "maxsim_serving_fp32": {
            "m": 64, "k": 64, "ms": timing["maxsim/nonzero"][0],
            "plain_ms": timing["maxsim/nonzero"][1], "max_abs_err": serving_err,
            "bound_ms": bounds["maxsim_fwd/serving"][0]},
        "maxsim_passes_ms": maxsim_passes,
        # the shape the CE kernels are for: M = N = 32768, D = 512, bf16
        "ce_32768": {
            **{f"fused_ce_{key}": {
                "ms": timing[f"fused_ce_{key}/32768"][0],
                "plain_ms": timing[f"fused_ce_{key}/32768"][1],
                "bound_ms": timing["ce_bounds/32768"][f"fused_ce_{key}"][0]}
               for key in ("fwd", "bwd_da", "bwd_db")},
            "dense_fwd_ms": timing["dense_ce/32768"][0],
            "dense_fwd_bwd_ms": timing["dense_ce/32768"][1]},
        "attention_text": {
            "batch": TRAIN_BATCH, "fwd_ms": timing["attention/text-train"][0],
            "bwd_ms": timing["attention_bwd/text"][0],
            "fwd_plain_ms": timing["attention/text-train"][1],
            "bwd_plain_ms": timing["attention_bwd/text"][1],
            "fwd_sdpa_ms": sdpa_text[0], "bwd_sdpa_ms": sdpa_text[1],
            "fwd_bound_ms": bounds["fused_attention_fwd/text"][0],
            "bwd_bound_ms": bounds["fused_attention_bwd/text"][0]},
        "attention_train_fwd_ms": dict(zip(("kernel", "plain", "sdpa", "bound"),
                                           (*timing["attention/vision-train"], sdpa_train[0],
                                            bounds["fused_attention_fwd/vision-train"][0]))),
        "ln_fwd_cases": ln_fwd_cases,
        "attention_vit_l": {
            "batch": MAX_BATCH, "fwd_ms": vit_l_fwd[0], "fwd_plain_ms": vit_l_fwd[1],
            "fwd_sdpa_ms": sdpa_l[0], "fwd_bound_ms": vit_l_bounds["fused_attention_fwd"][0],
            "bwd_ms": vit_l_bwd[0], "bwd_plain_ms": vit_l_bwd[1], "bwd_sdpa_ms": sdpa_l[1],
            "bwd_bound_ms": vit_l_bounds["fused_attention_bwd"][0]},
        "attention_registers": {k: v[0] for k, v in usage.items()},
        "vit_l_train": {"model": VIT_L_MODEL, "batch": VIT_L_BATCH, "step_ms": vit_l["step_ms"],
                        "launches": vit_l["launches"], "losses": vit_l["losses"]},
        "launches_search": int8["search_launches"],
        "quantize_rtn_five_calls_ms": timing[f"quantize_int8/{quant_key}"][2],
        "quantize_int8_device_ms": timing["quantize_int8_device_ms"],
        "quantize_int8_host_ms": timing["quantize_int8_host_ms"],
        "int8": {k: int8[k] for k in ("requant_ms", "encode", "maxsim_int8_err",
                                      "maxsim_int8_ms", "maxsim_kernel_ms", "step_ms", "loss_err",
                                      "index_img_per_s", "search_ms", "search_err")},
        "mlp_three_calls_ms": {"fwd": timing["fused_mlp_fwd/vision"][2],
                               "bwd": timing["fused_mlp_bwd/vision"][2]},
        "mlp_cases": {case: {
            f"{key}_{what}": value
            for key in ("fwd", "bwd")
            for what, value in zip(("ms", "plain_ms", "three_calls_ms", "bound_ms"),
                                   (*timing[f"fused_mlp_{key}/{case}"],
                                    mlp_case_bounds[case][f"fused_mlp_{key}"][0]))}
            for case in [c for c, *_ in MLP_CASES] + [wide]},
        "ln_bwd_cases": timing["ln_bwd_cases"],
        "ce_fwd_sizes": {m: {"ms": timing[f"fused_ce_fwd/{m}"][0],
                             "plain_ms": timing[f"fused_ce_fwd/{m}"][1],
                             "dense_fwd_ms": timing[f"dense_ce/{m}"][0],
                             "bound_ms": timing[f"ce_bounds/{m}"]["fused_ce_fwd"][0]}
                         for m in sorted(ce_sizes)},
        "ln_only_train_step": {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                               "ms": ln_only["step_ms"], "peak_gib": ln_only["peak_gib"],
                               "over_default": ln_only["over_default"],
                               "launches": ln_only["launches"]},
        "vit_l_fused_train": {"model": VIT_L_MODEL, "batch": VIT_L_BATCH,
                              "step_ms": vit_l_fused["step_ms"],
                              "peak_gib": vit_l_fused["peak_gib"],
                              "launches": vit_l_fused["launches"],
                              "losses": vit_l_fused["losses"], "fp32": vit_l_fused["fp32"]},
        "fused_train_step": {"batch": TRAIN_BATCH, "steps": FUSED_STEPS, "ms": fused["step_ms"],
                             "img_per_s": TRAIN_BATCH / fused["step_ms"] * 1e3,
                             "peak_gib": fused["peak_gib"],
                             "over_default": fused["step_ms"] / train["step_ms"]},
        "train_step": {"batch": TRAIN_BATCH, "ms": train["step_ms"],
                       "img_per_s": TRAIN_BATCH / train["step_ms"] * 1e3,
                       "peak_gib": train["peak_gib"]},
        "main": {"model": MAIN_MODEL, "batch": TRAIN_BATCH, "step_ms": trainer["step_ms"],
                 "samples_per_s": TRAIN_BATCH / trainer["step_ms"] * 1e3,
                 "data_ms": trainer["data_ms"], "peak_gib": trainer["peak_gib"],
                 "feed_ms": trainer["feed_ms"]},
        "eval": evaluation,
        "launches_tar": {name: run["launches"] for name, run in tar["runs"].items()},
        "tar": tar, "dist": data_parallel, "families": families, "pod": pod,
        "saves": saves, "gspmd": sharded, "aot": bundle}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

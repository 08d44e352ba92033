#!/bin/bash
# No-data smoke run of the PyTorch port: synthetic data, a short epoch, the
# whole training entry point (python -m colxlip_tpu_torch.main). The twin of
# test_smoke.sh with the same flags. It runs on cuda:0; pass --device cpu
# (or any other flag) after the script's name, as "$@" goes through last.
set -euo pipefail
python -m colxlip_tpu_torch.main \
    --model ViT-B-32-colxlip \
    --dataset-type synthetic \
    --train-num-samples 1024 \
    --batch-size 32 \
    --epochs 1 \
    --lr 1e-4 \
    --warmup 10 \
    --precision bf16 \
    --logs ./logs --name smoke \
    --log-every-n-steps 1 \
    "$@"

#!/bin/bash
# ColXLIP CC3M recipe on the PyTorch port: ViT-B-32-colxlip from a base
# checkpoint, lr 1e-5, warmup 2000, 32 epochs, alpha 0.7, batch 256 a
# process. The twin of train_colxlip_cc3m_v5e.sh on
# python -m colxlip_tpu_torch.main, with the same flags and variables
# (DATA, LOGS, PRETRAINED, COCO_DIR). One process trains on cuda:0; for
# several cards, launch one process a card with the --dist-* flags (or
# torchrun). Pass --device cpu (or any other flag) after the script's name,
# as "$@" goes through last. The port's main refuses --pipeline grain and
# --force-patch-dropout, so this launcher passes neither (nor does the JAX
# one).
set -euo pipefail

# the default is quoted: unquoted, the brace pattern's "}" would close the
# expansion and append ".tar}" to any DATA given (as in the JAX launcher)
DATA=${DATA:-"/data/cc3m/cc3m-train-{0000..0575}.tar"}
LOGS=${LOGS:-./logs}
PRETRAINED=${PRETRAINED:-}   # path to a base ViT-B-32 .pt

python -m colxlip_tpu_torch.main \
    --train-data "$DATA" \
    --train-num-samples 2823019 \
    --dataset-resampled \
    --logs "$LOGS" \
    --model ViT-B-32-colxlip \
    ${PRETRAINED:+--pretrained "$PRETRAINED"} \
    --alpha 0.7 \
    --batch-size 256 \
    --ship-format yuv420 \
    --packed-feed \
    --epochs 32 \
    --lr 1e-5 \
    --warmup 2000 \
    --precision bf16 \
    --workers 8 \
    --num-sampled-captions 8 \
    --save-frequency 1 \
    --delete-previous-checkpoint \
    --report-to jsonl \
    --retrieval-coco --coco-data-root-dir "${COCO_DIR:-/data/coco}" \
    "$@"

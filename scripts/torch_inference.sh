#!/bin/bash
# Eval-only run of the PyTorch port over all 7 retrieval suites, with
# token-level MaxSim late-interaction scoring: the twin of inference.sh on
# python -m colxlip_tpu_torch.main, with the same flags and variables
# (CKPT, DATAROOT, SCORING). It runs on cuda:0; pass --device cpu (or any
# other flag) after the script's name, as "$@" goes through last. A suite
# whose files are absent is logged and skipped. Then compare with
# scripts/torch_check_parity.py.
set -euo pipefail

CKPT=${CKPT:?set CKPT to an OpenCLIP-layout .pt (scripts/torch_export_pt.py writes one)}
# annotation JSONs are vendored in datasets/; drop the suite images in next
# to them per datasets/EVAL_DATASETS.md, or point DATAROOT at a full data
# directory
DATAROOT=${DATAROOT:-"$(cd "$(dirname "$0")/.." && pwd)/datasets"}

python -m colxlip_tpu_torch.main \
    --model ViT-B-16-colxlip \
    --pretrained "$CKPT" \
    --batch-size 256 \
    --eval-scoring "${SCORING:-mixed}" \
    --alpha 0.7 \
    --retrieval-coco --coco-data-root-dir "$DATAROOT/coco" \
    --retrieval-flickr --flickr-data-root-dir "$DATAROOT/flickr30k-images" \
    --retrieval-docci --docci-data-root-dir "$DATAROOT/docci" \
    --retrieval-urban-1k --urban-1k-data-root-dir "$DATAROOT/Urban1k" \
    --retrieval-dci --dci-data-root-dir "$DATAROOT/dci" \
    --retrieval-iiw --iiw-data-root-dir "$DATAROOT/imageinwords" --iiw-finegrained \
    --retrieval-sharegpt4v \
    --sharegpt4v-data-root-dir "$DATAROOT/sharegpt4v" \
    --sharegpt4v-json-1k "$DATAROOT/sharegpt4v/share-captioner_coco_lcs_sam_1246k_1107_1k.json" \
    --sharegpt4v-json-10k "$DATAROOT/sharegpt4v/share-captioner_coco_lcs_sam_1246k_1107_10k.json" \
    "$@"

"""Experiment flags: port of ``colxlip_tpu/params.py``.

The same flag names and defaults as the JAX entry point (per-model optimizer
defaults: ViT -> beta2 = 0.98, eps = 1e-6), plus ``--device``. Flags whose
feature the port does not have yet still parse here; ``main`` refuses them
before any model work.
"""
from __future__ import annotations

import argparse
import ast


def get_default_params(model_name: str) -> dict:
    """Per-arch optimizer defaults."""
    model_name = model_name.lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    """--aug-cfg key=value parser."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, _, v = value.partition("=")
            try:
                kw[key] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kw[key] = str(v)
        setattr(namespace, self.dest, kw)


def parse_args(args=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("python -m colxlip_tpu_torch.main")

    # data
    parser.add_argument("--train-data", type=str, default=None,
                        help="webdataset shard spec; '::' joins weighted sources")
    parser.add_argument("--train-data-upsampling-factors", type=str, default=None)
    parser.add_argument("--train-num-samples", type=int, default=None)
    parser.add_argument("--dataset-type", choices=["webdataset", "synthetic", "auto"],
                        default="auto")
    parser.add_argument("--dataset-resampled", default=False, action="store_true")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--num-sampled-captions", type=int, default=8)
    parser.add_argument("--max-merged-num", type=int, default=3)
    # the only caption-sampling mode there is; enforced at parse time
    parser.add_argument("--caption-sampling-mode", type=str,
                        default="diverse_sampling", choices=["diverse_sampling"])
    parser.add_argument("--pixelprose", default=False, action="store_true")
    parser.add_argument("--native-decode", default=False, action="store_true",
                        help="fused C++ JPEG decode+crop+resize loader core")
    parser.add_argument("--normalize-on-device", default=False,
                        action="store_true",
                        help="train batches ship as raw uint8 RGB and the "
                             "accelerator applies (x/255-mean)/std — 4x fewer "
                             "host->device bytes, numerically identical")
    parser.add_argument("--ship-format", type=str, default="rgb",
                        choices=["rgb", "yuv420"],
                        help="train-batch wire format: 'rgb' ships what the "
                             "transform emits (float32, or uint8 with "
                             "--normalize-on-device); 'yuv420' ships planar "
                             "YUV 4:2:0 uint8 (1.5 bytes/px — half of uint8 "
                             "RGB, 8x less than float32; implies "
                             "--normalize-on-device) and the vision tower "
                             "reconstructs normalized RGB on device "
                             "(ops/yuv420.py)")
    parser.add_argument("--prefetch-depth", type=int, default=2,
                        help="device-resident batches kept in flight per "
                             "prefetch stage (host + ship threads each); "
                             "deeper smooths transfer-latency jitter at the "
                             "cost of one extra batch of HBM per level")
    parser.add_argument("--packed-feed", default=False, action="store_true",
                        help="fuse images+texts into ONE host->device "
                             "transfer per step (the step unpacks in-jit) — "
                             "removes the second put's fixed per-call cost; "
                             "requires a uint8 wire format "
                             "(--normalize-on-device or --ship-format "
                             "yuv420) and the non-GSPMD step")
    parser.add_argument("--raw-aug", type=str, default="rrc",
                        choices=["rrc", "crop"],
                        help="augmentation on packed raw-uint8 shards "
                             "(data/pack.py): 'rrc' = exact RandomResizedCrop "
                             "semantics via one small PIL resize; 'crop' = "
                             "zero-PIL numpy random crop (translation-only "
                             "aug, cheapest host path)")
    parser.add_argument("--pipeline", type=str, default="wds",
                        choices=["wds", "grain"],
                        help="threaded tar pipeline vs grain mp-prefetch pipeline")
    parser.add_argument("--decode-threads", type=int, default=8)

    # retrieval eval suites
    parser.add_argument("--retrieval-coco", default=False, action="store_true")
    parser.add_argument("--coco-data-root-dir", type=str, default=None)
    parser.add_argument("--retrieval-flickr", default=False, action="store_true")
    parser.add_argument("--flickr-data-root-dir", type=str, default=None)
    parser.add_argument("--flickr-val-or-test", type=str, default="val")
    parser.add_argument("--retrieval-docci", default=False, action="store_true")
    parser.add_argument("--docci-data-root-dir", type=str, default=None)
    parser.add_argument("--retrieval-urban-1k", default=False, action="store_true")
    parser.add_argument("--urban-1k-data-root-dir", type=str, default=None)
    parser.add_argument("--retrieval-iiw", default=False, action="store_true")
    parser.add_argument("--iiw-data-root-dir", type=str, default=None)
    parser.add_argument("--iiw-finegrained", default=False, action="store_true")
    parser.add_argument("--retrieval-dci", default=False, action="store_true")
    parser.add_argument("--dci-data-root-dir", type=str, default=None)
    parser.add_argument("--retrieval-sharegpt4v", default=False, action="store_true")
    parser.add_argument("--sharegpt4v-data-root-dir", type=str, default=None)
    parser.add_argument("--sharegpt4v-json-1k", type=str, default=None)
    parser.add_argument("--sharegpt4v-json-10k", type=str, default=None)
    parser.add_argument("--imagenet-val", type=str, default=None,
                        help="ImageNet val dir for zero-shot eval")
    parser.add_argument("--imagenet-classnames", type=str, default=None,
                        help="JSON class-name list override (default: the "
                             "vendored OpenAI CLIP list)")
    parser.add_argument("--zeroshot-frequency", type=int, default=2)
    parser.add_argument("--val-frequency", type=int, default=1)

    # experiment / logging
    parser.add_argument("--logs", type=str, default="./logs/")
    parser.add_argument("--log-local", action="store_true", default=False,
                        help="non-master hosts also log, to out-<rank>.log")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--report-to", type=str, default="",
                        help="comma-separated: tensorboard,wandb,jsonl")
    parser.add_argument("--wandb-notes", type=str, default="",
                        help="wandb run notes")
    parser.add_argument("--wandb-project-name", type=str, default="colxlip_tpu",
                        help="wandb project")
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--copy-codebase", default=False, action="store_true")

    # checkpointing
    parser.add_argument("--resume", type=str, default=None,
                        help="path or 'latest'")
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--save-most-recent", action="store_true", default=False)
    parser.add_argument("--delete-previous-checkpoint", action="store_true", default=False)
    parser.add_argument("--async-checkpoint", action="store_true", default=False,
                        help="write checkpoints in a background thread "
                             "(not yet ported: refused by main)")
    parser.add_argument("--preempt-save", action="store_true", default=False,
                        help="on SIGTERM/SIGUSR1 (the scheduler's preemption "
                             "warnings), stop at the next step boundary, "
                             "write a mid-epoch epoch_latest checkpoint and "
                             "exit 0; --resume latest then continues from "
                             "the exact step")
    parser.add_argument("--preempt-check-every", type=int, default=20,
                        help="steps between preemption-stop checks; on "
                             "multi-host this is a tiny cross-host consensus "
                             "collective (hosts must stop at the same step)")
    parser.add_argument("--remote-sync", type=str, default=None)
    parser.add_argument("--remote-sync-frequency", type=int, default=300)
    parser.add_argument("--remote-sync-protocol", choices=["s3", "fsspec"], default="s3")

    # optimization
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-device batch size")
    parser.add_argument("--epochs", type=int, default=32)
    parser.add_argument("--epochs-cooldown", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None,
                        help="override (else derived from train-num-samples)")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--beta1", type=float, default=None)
    parser.add_argument("--beta2", type=float, default=None)
    parser.add_argument("--eps", type=float, default=None)
    parser.add_argument("--wd", type=float, default=0.2)
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--lr-scheduler", type=str, default="cosine",
                        choices=["cosine", "const", "const-cooldown"])
    parser.add_argument("--lr-cooldown-end", type=float, default=0.0)
    parser.add_argument("--lr-cooldown-power", type=float, default=1.0)
    parser.add_argument("--accum-freq", type=int, default=1)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument("--grad-checkpointing", default=False, action="store_true")
    parser.add_argument("--skip-scheduler", action="store_true", default=False)

    # model
    parser.add_argument("--model", type=str, default="ViT-B-32-colxlip")
    parser.add_argument("--pretrained", type=str, default="")
    parser.add_argument("--allow-degraded-tokenizer", default=False,
                        action="store_true",
                        help="permit the zero-merges BPE fallback together "
                             "with --pretrained (text parity WILL be wrong; "
                             "fetch the real table: scripts/fetch_assets.py)")
    parser.add_argument("--precision", type=str, default="bf16",
                        choices=["bf16", "pure_bf16", "fp32", "amp", "amp_bf16"])
    parser.add_argument("--image-mean", type=float, nargs="+", default=None,
                        metavar="MEAN",
                        help="override the model's image mean")
    parser.add_argument("--image-std", type=float, nargs="+", default=None,
                        metavar="STD",
                        help="override the model's image std")
    parser.add_argument("--force-quick-gelu", default=False, action="store_true")
    parser.add_argument("--gelu-approx", default=False, action="store_true",
                        help="tanh-approx GELU (~10%% faster tower; tiny numeric diff)")
    parser.add_argument("--force-patch-dropout", default=None, type=float)
    parser.add_argument("--force-image-size", type=int, default=None)
    parser.add_argument("--lock-image", default=False, action="store_true")
    parser.add_argument("--lock-text", default=False, action="store_true")
    parser.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs)
    parser.add_argument("--torchcompile", default=False, action="store_true",
                        help="accepted for CLI parity; has no effect")

    # loss
    parser.add_argument("--alpha", type=float, default=0.5,
                        help="global/token loss mix")
    parser.add_argument("--local-loss", default=False, action="store_true")
    parser.add_argument("--gather-with-grad", default=False, action="store_true")
    parser.add_argument("--siglip", default=False, action="store_true")
    parser.add_argument("--coca-caption-loss-weight", type=float, default=2.0,
                        help="caption CE weight for CoCa models")
    parser.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0,
                        help="contrastive weight for CoCa models")
    parser.add_argument("--token-mask-mode", type=str, default="nonzero",
                        choices=["nonzero", "valid"],
                        help="token-loss text mask: 'nonzero' = mean over "
                             "tokens whose max-sim is non-zero; 'valid' = "
                             "explicit pre-EOT validity mask")
    parser.add_argument("--distill-model", type=str, default=None)
    parser.add_argument("--distill-pretrained", type=str, default=None)
    parser.add_argument("--dist-impl", type=str, default=None,
                        choices=[None, "bidir", "shift", "reduce", "gather"])
    parser.add_argument("--maxsim-impl", type=str, default="auto",
                        choices=["auto", "xla", "streaming", "streaming_int8", "chunked", "pallas"],
                        help="'auto' dispatches 'streaming' (custom-VJP) for "
                             "training-scale shapes; explicit values force "
                             "one path")
    parser.add_argument("--ce-impl", type=str, default="dense",
                        choices=["dense", "fused"],
                        help="fused = streaming logsumexp CE kernels (no NxN logits)")
    parser.add_argument("--token-dist", type=str, default="gather",
                        choices=["gather", "ring"],
                        help="ring = blockwise ppermute token-feature exchange")
    parser.add_argument("--token-neighborhood", type=int, default=0,
                        help="cap token-CE negatives to a K-device ring "
                             "neighborhood (K*batch negatives instead of the "
                             "full global batch). The token MaxSim loss is "
                             "O(batch x global-batch) FLOPs — at 32k global "
                             "it is ~12x the towers' compute; this bounds it "
                             "while the pooled InfoNCE keeps all global "
                             "negatives. Requires --token-dist ring. 0 = full")
    parser.add_argument("--eval-scoring", type=str, default="global",
                        choices=["global", "maxsim", "mixed"])
    parser.add_argument("--text-ctx", type=int, default=0,
                        help="train-time text context length override (data "
                             "side only: tokenizer truncation + batch shape; "
                             "model params stay at the config's 77, the text "
                             "tower slices its positional embedding). The "
                             "reference always computes the full fixed 77 "
                             "(transformer.py:863) while web captions fit "
                             "far shorter windows (scripts/"
                             "caption_length_stats.py: >=96%% of coco/"
                             "flickr-style captions fit 32) — shrinking the "
                             "train context cuts both text-tower and token-"
                             "loss FLOPs. Eval keeps the full context. "
                             "0 = model default")

    # distributed
    parser.add_argument("--dist-coordinator", type=str, default=None,
                        help="coordinator address (multi-host)")
    parser.add_argument("--dist-num-processes", type=int, default=None)
    parser.add_argument("--dist-process-id", type=int, default=None)
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="mesh model-axis size (tensor sharding)")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3-style param+optimizer sharding over the "
                             "data axis (GSPMD step; composes with "
                             "--model-parallel)")

    # misc
    parser.add_argument("--device", type=str, default="cuda:0",
                        help="torch device of the model and the step; 'cpu' "
                             "runs the kernels' plain versions")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="torch.profiler chrome-trace output dir "
                             "(steps 2-4 of the first epoch run)")
    parser.add_argument("--log-every-n-steps", type=int, default=100)

    ns = parser.parse_args(args)

    # per-arch defaults applied post-parse
    defaults = get_default_params(ns.model)
    for name, val in defaults.items():
        if getattr(ns, name) is None:
            setattr(ns, name, val)
    return ns

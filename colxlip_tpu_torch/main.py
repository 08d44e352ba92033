"""The training entry point: ``python -m colxlip_tpu_torch.main``, port of
``colxlip_tpu/main.py``.

Experiment naming, the log directory with ``params.txt`` and ``out.log``,
``--resume latest|<path>``, model / optimizer / schedule construction, the
train data (WebDataset tar shards through ``data/wds.py`` with
``--train-data``: the train transforms, ``--native-decode``, the uint8
(``--normalize-on-device``) and YUV420 (``--ship-format yuv420``) wire
formats, ``--packed-feed``; else the synthetic dataset), the epoch loop
with numbered and most-recent checkpoint saves and rotation (written by a
background thread under ``--async-checkpoint``), ``--preempt-save``, the
retrieval suites (``--retrieval-*``) and zero-shot ImageNet
(``--imagenet-val``) at the end of an epoch (``--val-frequency``,
``--zeroshot-frequency``, ``--eval-scoring``), and the eval-only mode:
without ``--train-data`` and with a ``--dataset-type`` other than
``synthetic``, ``main`` evaluates the ``--pretrained`` weights (before any
``--resume``, as the JAX entry point does), appends
``checkpoints/results.jsonl`` and returns. It runs on
``--device`` (``cuda:0`` unless told otherwise) and raises when that device
is missing.

Data parallelism, one process a device: ``--dist-coordinator host:port
--dist-num-processes N --dist-process-id R`` (or torchrun's environment)
joins a ``torch.distributed`` group, NCCL on the card and gloo with
``--device cpu``; rank r trains on ``cuda:<local rank>``. ``--batch-size`` is
per rank. Rank 0 names the run and finds ``--resume latest`` for every
rank (broadcast), writes ``params.txt``, ``out.log``, ``metrics.jsonl`` and
every checkpoint, and runs the epoch-end eval while the others wait;
``--log-local`` gives rank r its own ``out-<r>.log``. Every rank loads the
resumed checkpoint.

The loss is chosen as the JAX ``create_loss`` chooses it: a CoCa model
trains the contrastive and caption terms (``--coca-contrastive-loss-weight``,
``--coca-caption-loss-weight``; ``--ce-impl fused`` streams the caption CE);
``--distill-model`` with ``--distill-pretrained`` (a local ``.pt``) distils
from that teacher, run forward only; ``--siglip`` trains the sigmoid loss,
its negatives exchanged across ranks as ``--dist-impl`` says (default
'bidir'); else colclip for a ColXLIP model and clip for the rest.

What the port cannot do yet is refused, never ignored: each such flag logs
an error and ``main`` returns 1 before any model work (``unsupported_flags``
lists them with the module each waits for; ``feed_errors`` the feed flags
that cannot hold together, as the JAX entry point refuses them).
"""
from __future__ import annotations

import logging
import os
import shutil
import signal
import sys
import threading
import time
from datetime import datetime
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .data.retrieval import RetrievalSuite, build_retrieval_suite
from .data.synthetic import SyntheticConfig, SyntheticDataset
from .data.transforms import AugmentationCfg
from .data.wds import SharedEpoch, WdsConfig, WdsTrainPipeline
from .factory import (compute_dtype, create_loss, create_model_and_transforms, create_teacher,
                      get_tokenizer)
from .ops.yuv420 import yuv420_rows
from .parallel.mesh import (
    broadcast_str, collective_device, create_mesh, initialize_multihost, rank, world)
from .parallel.data_feed import global_batch_size
from .parallel.train_step import make_train_step
from .params import parse_args
from .training.checkpoint import (
    get_latest_checkpoint, load_native_checkpoint, read_step_in_epoch, restore_train_state,
    rotate_checkpoints, save_checkpoint, save_checkpoint_async, train_state, wait_for_saves)
from .training.evaluate import evaluate
from .training.logging_utils import MetricsWriter, dump_params, setup_logging
from .training.optim import create_optimizer
from .training.schedules import const_lr, const_lr_cooldown, cosine_lr
from .training.train import train_one_epoch

logger = logging.getLogger(__name__)


def copy_codebase(args) -> None:
    """Snapshot the package source into the experiment directory."""
    new_code_path = os.path.join(args.logs, args.name, "code")
    if os.path.exists(new_code_path):
        logger.error("Error: experiment code dir %s already exists", new_code_path)
        return
    logger.info("Copying codebase to %s", new_code_path)
    current_code_path = os.path.dirname(os.path.realpath(__file__))
    shutil.copytree(
        current_code_path, os.path.join(new_code_path, "colxlip_tpu_torch"),
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "logs", "wandb", "build"))


def generate_name(args) -> str:
    """Automatic experiment name: date, model, lr, batch, precision."""
    date_str = datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
    model_name_safe = args.model.replace("/", "-")
    return "-".join([
        date_str,
        f"model_{model_name_safe}",
        f"lr_{args.lr}",
        f"b_{args.batch_size}",
        f"p_{args.precision}",
    ])


def build_lr_schedule(args, total_steps: int) -> Callable[[int], float]:
    if args.lr_scheduler == "cosine":
        return cosine_lr(args.lr, args.warmup, total_steps)
    if args.lr_scheduler == "const":
        return const_lr(args.lr, args.warmup)
    if args.lr_scheduler == "const-cooldown":
        cooldown_steps = (args.epochs_cooldown or 0) * max(
            total_steps // max(args.epochs, 1), 1)
        return const_lr_cooldown(args.lr, args.warmup, total_steps, cooldown_steps,
                                 args.lr_cooldown_power, args.lr_cooldown_end)
    raise ValueError(f"Unknown scheduler {args.lr_scheduler}")


def retrieval_suite_specs(args) -> List[Tuple[str, dict]]:
    """(suite name, reader arguments) for every suite whose flag is set and
    whose reader arguments are all given, in the JAX order."""
    specs = [
        (args.retrieval_coco, "coco", {"root_dir": args.coco_data_root_dir, "split": "val"}),
        (args.retrieval_flickr, "flickr",
         {"root_dir": args.flickr_data_root_dir, "split": args.flickr_val_or_test}),
        (args.retrieval_docci, "docci", {"root_dir": args.docci_data_root_dir}),
        (args.retrieval_urban_1k, "urban_1k", {"root_dir": args.urban_1k_data_root_dir}),
        (args.retrieval_dci, "dci", {"root_dir": args.dci_data_root_dir}),
        (args.retrieval_iiw, "iiw",
         {"root_dir": args.iiw_data_root_dir, "finegrained": args.iiw_finegrained}),
        (args.retrieval_sharegpt4v and args.sharegpt4v_json_1k is not None, "sharegpt4v-1k",
         {"root_dir": args.sharegpt4v_data_root_dir, "json_name": args.sharegpt4v_json_1k}),
        (args.retrieval_sharegpt4v and args.sharegpt4v_json_10k is not None, "sharegpt4v-10k",
         {"root_dir": args.sharegpt4v_data_root_dir, "json_name": args.sharegpt4v_json_10k}),
    ]
    return [(name, reader_args) for flag, name, reader_args in specs
            if flag and all(v is not None for v in reader_args.values())]


def build_retrieval_suites(args, tokenizer, preprocess_val) -> List[RetrievalSuite]:
    """The configured suites; one that fails to build (a missing file, a
    missing key) is logged and skipped, as in the JAX entry point."""
    suites = []
    for name, reader_args in retrieval_suite_specs(args):
        try:
            suites.append(build_retrieval_suite(name, reader_args, tokenizer, preprocess_val))
        except (OSError, KeyError) as e:
            logger.warning("skipping retrieval suite %s: %s", name, e)
    return suites


def unsupported_flags(args) -> List[str]:
    """One message per flag of ``args`` whose feature is not ported yet, each
    naming the module it waits for."""
    checks = [
        (bool(args.remote_sync),
         "--remote-sync: remote sync (utils/file_utils.py) is not yet ported"),
        (args.model_parallel > 1,
         "--model-parallel > 1: tensor parallelism (parallel/gspmd.py) is not yet ported"),
        (args.fsdp, "--fsdp: sharded state (parallel/gspmd.py) is not yet ported"),
        (args.pipeline == "grain",
         "--pipeline grain: the grain pipeline (data/grain_pipeline.py) is not yet ported "
         "(use the default --pipeline wds)"),
        (args.force_patch_dropout is not None,
         "--force-patch-dropout: the train step has no generator for PatchDropout's draw. "
         "The JAX step passes no 'patch_dropout' rng either and raises flax "
         "InvalidRngError with this flag, so the port refuses it too (the module and the "
         "tower option are ported: models/layers.py PatchDropout)"),
    ]
    return [msg for bad, msg in checks if bad]


def feed_errors(args) -> List[str]:
    """One message per flag of ``args`` that cannot hold on this train feed,
    as the JAX entry point refuses them: ``--packed-feed`` needs a uint8 wire
    format and the tar pipeline; ``--aug-cfg`` takes only known keys."""
    errors = []
    if args.packed_feed:
        if not (args.normalize_on_device or args.ship_format == "yuv420"):
            errors.append("--packed-feed requires a uint8 wire format: add "
                          "--normalize-on-device or --ship-format yuv420")
        if args.dataset_type == "synthetic" or not args.train_data:
            errors.append("--packed-feed requires the webdataset pipeline (the synthetic "
                          "dataset emits float32 batches)")
    if args.aug_cfg:
        try:
            AugmentationCfg.from_kwargs(args.aug_cfg)
        except ValueError as e:
            errors.append(str(e))
    return errors


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    created = initialize_multihost(args.dist_coordinator, args.dist_num_processes,
                                   args.dist_process_id,
                                   backend="gloo" if device.type == "cpu" else "nccl")
    try:
        return _main(args, device)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args, device: torch.device) -> int:
    group = create_mesh() if dist.is_initialized() else None
    is_master = rank() == 0
    n_ranks = world()
    if group is not None and device.type == "cuda":
        device = collective_device(group)      # cuda:<local rank>

    if args.name is None:
        # rank 0 names the run; the broadcast makes every rank agree
        args.name = broadcast_str(generate_name(args), group)
    log_base = os.path.join(args.logs, args.name)
    checkpoint_dir = os.path.join(log_base, "checkpoints")
    log_path = None
    if is_master:
        os.makedirs(checkpoint_dir, exist_ok=True)
        log_path = os.path.join(log_base, "out.log")
    elif args.log_local:
        log_path = os.path.join(log_base, f"out-{rank()}.log")
    setup_logging(log_path, logging.DEBUG if args.debug else logging.INFO)
    if is_master:
        dump_params(args, os.path.join(log_base, "params.txt"))
        if args.copy_codebase:
            copy_codebase(args)

    refused = unsupported_flags(args) + feed_errors(args)
    for msg in refused:
        logger.error("%s", msg)
    if refused:
        return 1
    eval_only = not args.train_data and args.dataset_type != "synthetic"
    if eval_only and not retrieval_suite_specs(args) and not args.imagenet_val:
        logger.error("eval-only mode but no retrieval suites configured")
        return 1
    logger.info("Running on %s (rank %d of %d).", device, rank(), n_ranks)

    resume_from: Optional[str] = None
    if args.resume == "latest":
        # rank 0 discovers and broadcasts, so a checkpoint landing mid-discovery
        # on a shared file system cannot split the ranks
        found = get_latest_checkpoint(checkpoint_dir) if is_master else ""
        resume_from = broadcast_str(found or "", group) or None
        if resume_from:
            logger.info("Found latest checkpoint: %s", resume_from)
    elif args.resume:
        resume_from = args.resume

    # Pretrained weights demand bit-compatible BPE tokenization: without the
    # merge table this is an error before any model work (escape hatch:
    # --allow-degraded-tokenizer).
    needs_parity_tokenizer = bool(args.pretrained) or bool(
        resume_from and resume_from.endswith(".pt"))
    require_merges = needs_parity_tokenizer and not args.allow_degraded_tokenizer
    tokenizer = get_tokenizer(args.model, require_merges=require_merges)
    # --text-ctx: train-time data-side context override (the text tower
    # slices its positional embedding to the input length)
    train_ctx = args.text_ctx or 0
    train_tokenizer = tokenizer
    if train_ctx:
        if not 3 <= train_ctx <= tokenizer.context_length:
            logger.error("--text-ctx %d must be in [3, %d] (the model's context)",
                         train_ctx, tokenizer.context_length)
            return 1
        train_tokenizer = get_tokenizer(args.model, context_length=train_ctx,
                                        require_merges=require_merges)
        logger.info("Train text context: %d (eval keeps %d)", train_ctx,
                    tokenizer.context_length)

    model, cfg, preprocess_train, preprocess_val = create_model_and_transforms(
        args.model,
        pretrained=args.pretrained or None,
        device=device,
        precision=args.precision,
        quick_gelu=True if args.force_quick_gelu else None,
        force_image_size=args.force_image_size,
        grad_checkpointing=args.grad_checkpointing,
        alpha=args.alpha,
        gelu_approximate=args.gelu_approx,
        seed=args.seed,
        image_mean=tuple(args.image_mean) if args.image_mean else None,
        image_std=tuple(args.image_std) if args.image_std else None,
        aug_cfg=AugmentationCfg.from_kwargs(args.aug_cfg) if args.aug_cfg else None,
        normalize_on_device=args.normalize_on_device,
        raw_aug=args.raw_aug,
        ship=args.ship_format,
    )
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Model: %s (%.1fM params)", args.model, n_params / 1e6)

    suites = build_retrieval_suites(args, tokenizer, preprocess_val)
    zero_shot_fn = None
    if args.imagenet_val:
        from .training.zero_shot import zero_shot_eval

        def zero_shot_fn(m):  # noqa: E306
            return zero_shot_eval(m, tokenizer, preprocess_val, args.imagenet_val,
                                  batch_size=args.batch_size,
                                  classnames_path=args.imagenet_classnames)

    def run_eval(epoch: int, zs) -> None:
        evaluate(model, suites, epoch=epoch, batch_size=args.batch_size,
                 scoring=args.eval_scoring, alpha=args.alpha,
                 results_file=os.path.join(checkpoint_dir, "results.jsonl"),
                 zero_shot_fn=zs, maxsim_impl=args.maxsim_impl,
                 mask_mode=args.token_mask_mode)

    def eval_on_rank0(epoch: int, zs) -> None:
        if is_master:
            run_eval(epoch, zs)
        if group is not None:
            dist.barrier(group)

    if eval_only:
        if not suites and zero_shot_fn is None:
            logger.error("eval-only mode but no retrieval suites configured")
            return 1
        eval_on_rank0(0, zero_shot_fn)
        return 0

    # --batch-size is per rank; each rank's feed yields its own rows of the
    # global batch
    global_batch = global_batch_size(args.batch_size)
    ctx = train_ctx or cfg.text_cfg.context_length
    if args.dataset_type == "synthetic" or not args.train_data:
        num_samples = args.train_num_samples or global_batch * 100
        size = cfg.vision_cfg.image_size
        size = size if isinstance(size, int) else size[0]
        train_data = SyntheticDataset(SyntheticConfig(
            batch_size=args.batch_size, image_size=(size, size), context_length=ctx,
            num_sampled_captions=args.num_sampled_captions,
            seed=args.seed, num_samples=num_samples, rank=rank(), world_size=n_ranks))
        num_batches = len(train_data)
    else:
        # the step reads caption 0 only (select_caption0): one i.i.d. draw
        # gives it the same distribution without tokenizing k - 1 more
        wds_cfg = WdsConfig(
            urls=args.train_data, weights=args.train_data_upsampling_factors,
            batch_size=args.batch_size, num_samples=args.train_num_samples,
            resampled=args.dataset_resampled, seed=args.seed, num_workers=args.workers,
            num_sampled_captions=1, max_merged_num=args.max_merged_num,
            pixelprose=args.pixelprose, native_decode=args.native_decode,
            decode_threads=args.decode_threads, rank=rank(), world_size=n_ranks)
        train_data = WdsTrainPipeline(wds_cfg, preprocess_train, train_tokenizer,
                                      SharedEpoch(0))
        num_batches = train_data.num_batches or 1000
    steps_per_epoch = args.steps_per_epoch or num_batches
    total_steps = steps_per_epoch * args.epochs

    lr_schedule = build_lr_schedule(args, total_steps)
    optimizer = create_optimizer(
        model, args.lr if args.skip_scheduler else lr_schedule,
        beta1=args.beta1, beta2=args.beta2, eps=args.eps, weight_decay=args.wd,
        grad_clip_norm=args.grad_clip_norm, lock_image=args.lock_image,
        lock_text=args.lock_text)
    packed_spec = None
    if args.packed_feed:
        h, w = preprocess_train.cfg.size_hw
        img_shape = (yuv420_rows(h), w) if args.ship_format == "yuv420" else (h, w, 3)
        packed_spec = (img_shape, ctx)
        logger.info("Packed feed: one %s + texts buffer a step", img_shape)
    loss_cfg = create_loss(args)
    teacher = None
    if loss_cfg.loss_type == "distill":
        teacher = create_teacher(args.distill_model, args.distill_pretrained, device,
                                 compute_dtype(args.precision), seed=args.seed)
        logger.info("Distilling from %s (%s)", args.distill_model, args.distill_pretrained)
    step_fn = make_train_step(model, optimizer,
                              None if args.skip_scheduler else lr_schedule,
                              loss_cfg, mesh=group, packed_feed=packed_spec, teacher=teacher)

    start_epoch = 0
    resume_step_in_epoch = 0
    if resume_from:
        restored = load_native_checkpoint(resume_from)
        start_epoch = int(restored["epoch"])
        resume_step_in_epoch = read_step_in_epoch(resume_from)
        step_fn.step = restore_train_state(restored["state"], model, optimizer)
        logger.info("=> resuming checkpoint '%s' (epoch %d%s)", resume_from, start_epoch,
                    f", step {resume_step_in_epoch}" if resume_step_in_epoch else "")

    writer = MetricsWriter(
        log_base, args.report_to, wandb_project=args.wandb_project_name,
        wandb_notes=args.wandb_notes, run_name=args.name,
        resume=resume_from is not None, config=vars(args)) if is_master else None

    # preemption hook: the scheduler's warning signal sets a flag; the epoch
    # loop stops at a step boundary, main saves a mid-epoch epoch_latest and
    # returns 0
    stop_event = None
    if args.preempt_save:
        stop_event = threading.Event()

        def _on_preempt(signum, frame):  # noqa: ARG001 - the signal API's shape
            logger.warning("received signal %d: will checkpoint and exit at the "
                           "next step boundary", signum)
            stop_event.set()

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            signal.signal(sig, _on_preempt)

    for epoch in range(start_epoch, args.epochs):
        logger.info("Start epoch %d", epoch)
        if hasattr(train_data, "set_epoch"):
            train_data.set_epoch(epoch)
        skip = resume_step_in_epoch if epoch == start_epoch else 0
        t0 = time.perf_counter()
        steps, stopped = train_one_epoch(
            step_fn, train_data, device=device, packed=packed_spec is not None, epoch=epoch,
            global_batch_size=global_batch, num_devices=n_ranks,
            log_every_n_steps=args.log_every_n_steps, writer=writer,
            steps_per_epoch=steps_per_epoch, lr_schedule=lr_schedule,
            profiler_dir=args.profile_dir if epoch == start_epoch else None,
            skip_steps=skip, stop_flag=stop_event,
            stop_check_every=args.preempt_check_every,
            prefetch_depth=args.prefetch_depth, group=group)
        if stopped:
            step_done = skip + steps
            logger.info("Preempted in epoch %d after step %d/%d: saving mid-epoch "
                        "checkpoint", epoch, step_done, steps_per_epoch)
            wait_for_saves()     # never race an epoch save still in flight
            if is_master:
                save_checkpoint(checkpoint_dir, train_state(model, optimizer, step_fn.step),
                                epoch=epoch, name=args.name, most_recent=True,
                                step_in_epoch=step_done)
            break
        logger.info("Epoch %d done: %d steps in %.1fs", epoch, steps,
                    time.perf_counter() - t0)
        completed_epoch = epoch + 1

        if (suites or zero_shot_fn is not None) and (
                (args.val_frequency > 0 and completed_epoch % args.val_frequency == 0)
                or completed_epoch == args.epochs):
            eval_on_rank0(completed_epoch, zero_shot_fn if (
                zero_shot_fn is not None and args.zeroshot_frequency > 0
                and completed_epoch % args.zeroshot_frequency == 0) else None)

        do_numbered = is_master and args.save_frequency > 0 and (
            completed_epoch % args.save_frequency == 0 or completed_epoch == args.epochs)
        if args.async_checkpoint and (do_numbered or (is_master and args.save_most_recent)):
            # one snapshot feeds the numbered and the latest writes; the
            # writes and the rotation overlap the next epoch
            save_checkpoint_async(
                checkpoint_dir, train_state(model, optimizer, step_fn.step),
                epoch=completed_epoch, name=args.name, most_recent=not do_numbered,
                also_most_recent=do_numbered and args.save_most_recent,
                rotate_keep_epoch=(completed_epoch if do_numbered
                                   and args.delete_previous_checkpoint else None))
        elif do_numbered or (is_master and args.save_most_recent):
            state = train_state(model, optimizer, step_fn.step)
            if do_numbered:
                save_checkpoint(checkpoint_dir, state, epoch=completed_epoch,
                                name=args.name)
                if args.delete_previous_checkpoint:
                    rotate_checkpoints(checkpoint_dir, completed_epoch)
            if args.save_most_recent:
                save_checkpoint(checkpoint_dir, state, epoch=completed_epoch,
                                name=args.name, most_recent=True)

    wait_for_saves()             # raises if a background save failed
    if writer is not None:
        writer.close()
    if group is not None:
        dist.barrier(group)      # every rank leaves after rank 0's last save
    return 0


if __name__ == "__main__":
    sys.exit(main())

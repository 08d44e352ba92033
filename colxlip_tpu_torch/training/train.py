"""Host-side epoch loop: port of ``colxlip_tpu/training/train.py``.

Feeds batches to the train step and logs throughput with the JAX loop's
meters (``data_time``, ``batch_time``, samples/s and samples/s/device),
caption-0 selection, the ``text_trunc_rate`` meter and periodic logging.
Batches reach the device through a two-stage background prefetch: a host
thread drains the input pipeline and a ship thread copies each batch
through pinned memory onto the step's device on its own CUDA stream
(``parallel.data_feed.DeviceFeeder``; with ``packed`` one fused buffer a
step), so the host work and the copy of batches i+1 and i+2 overlap the
device's work on batch i. The host thread closes the pipeline's iterator
when it stops, so a tar pipeline's worker threads end with the epoch even
when ``steps_per_epoch`` cuts it short.

The loop never waits for the device between steps: CUDA launches are
asynchronous, the step's metrics stay device tensors, and they are read
only at log boundaries (every ``log_every_n_steps`` steps and at the last
step), where the work of the whole window completes.

Under data parallelism (``group``) every rank runs this loop on its own
rows; the stop request is agreed on at the check boundaries
(``_stop_consensus``), so every rank leaves the epoch at the same step.

The truncation meter counts a caption as truncated when EOT sits in the last
slot, as the JAX loop does: a caption that fits the context exactly counts
too.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.tokenizer import EOT_TOKEN
from ..parallel.data_feed import DeviceFeeder
from .logging_utils import AverageMeter, MetricsWriter

logger = logging.getLogger(__name__)


def select_caption0(texts: np.ndarray) -> np.ndarray:
    """[B, k, ctx] -> [B, ctx]: keep sampled caption 0."""
    if texts.ndim == 3:
        return texts[:, 0]
    return texts


class _PrefetchIterator:
    """Two-stage background prefetch: a HOST thread drains the input pipeline
    (decode / augment / tokenize) and a SHIP thread moves batches host ->
    device, each keeping up to ``depth`` batches in flight, so the steady
    state is max(host, transfer, compute), not their sum.

    The ship stage is a ``DeviceFeeder`` on ``device`` (``packed``: one
    fused buffer, the item (buf, None)); it waits for its copy itself, never
    the training thread. The device is always named by the caller: there is
    no default to fall to.

    Exceptions from either stage re-raise in the consumer. ``close()`` stops
    both threads promptly when the consumer exits early; the host thread
    then closes the input iterator (a generator is closed by the thread that
    runs it, so its ``finally`` stops whatever threads it started).
    """

    _DONE = object()

    def __init__(self, dataloader: Iterable, device: Union[str, torch.device],
                 depth: int = 2, trunc_meter: Optional[AverageMeter] = None,
                 packed: bool = False):
        self._host_q: queue.Queue = queue.Queue(maxsize=depth)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._feeder = DeviceFeeder(device, packed=packed)
        self._trunc_meter = trunc_meter
        self._it = iter(dataloader)
        self._host_thread = threading.Thread(target=self._produce_host, daemon=True)
        self._ship_thread = threading.Thread(target=self._produce_ship, daemon=True)
        self._host_thread.start()
        self._ship_thread.start()

    def _prep(self, images, texts):
        texts = select_caption0(np.asarray(texts))
        if self._trunc_meter is not None and texts.ndim == 2 and texts.size:
            # EOT forced into the LAST slot <=> the caption hit the context
            # cap (the tokenizer's truncation contract): makes a mis-sized
            # --text-ctx visible in the train log instead of silent
            self._trunc_meter.update(float((texts[:, -1] == EOT_TOKEN).mean()))
        # uint8 batches stay as they are (the device-side normalisation
        # feeds); anything else feeds the step as float32
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = np.asarray(images, np.float32)
        return images, texts

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce_host(self):
        try:
            for batch in self._it:
                if not self._put(self._host_q, self._prep(*batch)):
                    return
            item = self._DONE
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            # BaseException: a SystemExit/KeyboardInterrupt raised inside
            # library code must still post a sentinel, or the ship stage's
            # queue.get would hang for ever
            item = e if isinstance(e, Exception) else RuntimeError(
                f"prefetch host stage died: {type(e).__name__}: {e}")
        finally:
            # this thread runs the iterator, so only it may close it (from
            # another thread: "generator already executing")
            close = getattr(self._it, "close", None)
            if close is not None:
                close()
        self._put(self._host_q, item)

    def _produce_ship(self):
        while not self._stop.is_set():
            try:
                got = self._host_q.get(timeout=0.5)
            except queue.Empty:
                if not self._host_thread.is_alive():
                    # the host thread may have posted its final sentinel and
                    # exited between the timeout and the is_alive() check:
                    # drain once more before concluding it is missing
                    try:
                        got = self._host_q.get_nowait()
                    except queue.Empty:
                        self._put(self._q, RuntimeError(
                            "prefetch host thread died without a sentinel"))
                        return
                else:
                    continue
            if got is self._DONE or isinstance(got, Exception):
                self._put(self._q, got)
                return
            try:
                item = self._feeder(*got)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                item = e if isinstance(e, Exception) else RuntimeError(
                    f"prefetch ship stage died: {type(e).__name__}: {e}")
                self._put(self._q, item)
                return
            if not self._put(self._q, item):
                return

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=5.0)
                break
            except queue.Empty:
                if not self._ship_thread.is_alive():
                    raise RuntimeError("prefetch ship thread died without a sentinel")
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so blocked puts wake up
        for q in (self._q, self._host_q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        self._host_thread.join(timeout=5.0)
        self._ship_thread.join(timeout=5.0)


class _Trace:
    """``torch.profiler`` over steps 2-4 of an epoch, exported as a chrome
    trace under ``profiler_dir``; on a CUDA device it also logs the kernels'
    summed time against the window's wall time (the device's idle share,
    the profiler's own cost included)."""

    def __init__(self, profiler_dir: str, epoch: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profiler_dir, exist_ok=True)
        self.path = os.path.join(profiler_dir, f"trace_epoch_{epoch}.json")
        self._device = device
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        logger.info("profiler trace written to %s", self.path)
        if self._device.type == "cuda":
            device_ms = sum(e.self_device_time_total for e in self._prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            logger.info("profiled steps: %.1f ms of kernels in %.1f ms (device idle %.1f%%)",
                        device_ms, wall_ms, 100 * max(0.0, 1 - device_ms / wall_ms))


def _stop_consensus(local_stop: bool, group: Optional[dist.ProcessGroup],
                    device: torch.device) -> bool:
    """Whether any rank of ``group`` was asked to stop (one int32 MAX
    all-reduce on ``device``; the local flag alone without a group). Every
    rank must leave at the same step boundary: a lone rank that leaves
    strands the others in the next step's collective."""
    if group is None:
        return local_stop
    flag = torch.tensor([int(local_stop)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def train_one_epoch(
    step_fn,
    dataloader: Iterable,
    *,
    epoch: int,
    global_batch_size: int,
    num_devices: int = 1,
    log_every_n_steps: int = 100,
    writer: Optional[MetricsWriter] = None,
    steps_per_epoch: Optional[int] = None,
    lr_schedule=None,
    profiler_dir: Optional[str] = None,
    device: Union[str, torch.device],
    packed: bool = False,
    prefetch_depth: int = 2,
    skip_steps: int = 0,
    stop_flag=None,
    stop_check_every: int = 20,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[int, bool]:
    """Run one epoch; returns (steps_run, stopped_early).

    ``step_fn(images, texts) -> metrics`` is the train step
    (``parallel.train_step.TrainStep``): it owns the model and the optimizer,
    and ``step_fn.step`` counts the updates made so far. ``device`` is where
    the batches are shipped (the step's device); it has no default.
    ``packed``: each batch ships as one ``pack_batch`` buffer and the step
    gets (buf, None); it must be built with the matching ``packed_feed``.

    skip_steps: consume (and discard) this many leading batches before
    training, the mid-epoch resume fast-forward. A deterministic pipeline
    (the synthetic one) replays the exact remaining stream. The skipped
    batches are never shipped to the device.

    stop_flag: a ``threading.Event``-like object; when set, training stops at
    the next ``stop_check_every`` step boundary and returns
    ``stopped_early=True`` so the caller can checkpoint. With ``group`` (the
    data-parallel group; ``device`` is this rank's) a flag set on any rank
    stops every rank there (``_stop_consensus``).
    """
    batch_time_m = AverageMeter()
    data_time_m = AverageMeter()
    trunc_m = AverageMeter()
    device = torch.device(device)

    raw_it = iter(dataloader)
    for _ in range(skip_steps):
        try:
            next(raw_it)
        except StopIteration:
            break
    if steps_per_epoch is not None:
        steps_per_epoch = max(steps_per_epoch - skip_steps, 0)

    prefetch = _PrefetchIterator(raw_it, device=device, depth=prefetch_depth,
                                 trunc_meter=trunc_m, packed=packed)
    start_step = int(step_fn.step)   # a host counter: no device read
    end = time.perf_counter()
    window_start = end
    last_log_i = 0
    steps_run = 0
    stopped = False
    metrics: Dict[str, torch.Tensor] = {}
    trace: Optional[_Trace] = None
    trunc_warned = False
    try:
        for i, (images, texts) in enumerate(prefetch):
            if steps_per_epoch is not None and i >= steps_per_epoch:
                break
            # with prefetch, data_time measures true starvation (queue wait)
            data_time_m.update(time.perf_counter() - end)

            if profiler_dir and i == 2:
                trace = _Trace(profiler_dir, epoch, device)
            metrics = step_fn(images, texts)
            if trace is not None and i == 4:
                trace.stop()
                trace = None

            steps_run += 1
            step_idx = start_step + steps_run

            if (i % log_every_n_steps) == 0 or (
                    steps_per_epoch is not None and i == steps_per_epoch - 1):
                # sync point: reading the metrics waits for the device, and
                # the work of the whole window since the previous read
                # completes here, so throughput is metered over the window
                host_metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                window_steps = i - last_log_i if i > last_log_i else 1
                batch_time_m.update((now - window_start) / window_steps)
                last_log_i, window_start = i, now
                samples_per_s = global_batch_size / max(batch_time_m.val, 1e-9)
                lr = float(lr_schedule(step_idx)) if lr_schedule is not None else float("nan")
                logger.info(
                    "Train Epoch: %d [step %d] total_loss: %.5g "
                    "data_time: %.3f batch_time: %.3f samples/s: %.1f "
                    "samples/s/device: %.1f lr: %.3g logit_scale: %.3f",
                    epoch, step_idx, host_metrics.get("total_loss", float("nan")),
                    data_time_m.val, batch_time_m.val, samples_per_s,
                    samples_per_s / max(num_devices, 1), lr,
                    host_metrics.get("logit_scale", float("nan")),
                )
                if not trunc_warned and trunc_m.count and trunc_m.avg > 0.05:
                    trunc_warned = True
                    logger.warning(
                        "text_trunc_rate %.1f%%: captions are hitting the text "
                        "context cap; if this feed trains with --text-ctx, the "
                        "cap may be under-sized", 100 * trunc_m.avg)
                if writer is not None:
                    host_metrics.update({
                        "samples_per_second": samples_per_s,
                        "samples_per_second_per_device": samples_per_s / max(num_devices, 1),
                        "text_trunc_rate": trunc_m.avg,
                        "data_time": data_time_m.val,
                        "batch_time": batch_time_m.val,
                        "lr": lr,
                        "epoch": epoch,
                    })
                    writer.write(host_metrics, step_idx)
            if stop_flag is not None and (i % stop_check_every) == 0:
                if _stop_consensus(stop_flag.is_set(), group, device):
                    stopped = True
                    logger.info("stop requested: leaving epoch %d after %d step(s)",
                                epoch, skip_steps + steps_run)
                    break
            end = time.perf_counter()
    finally:
        prefetch.close()
        if trace is not None:
            # an epoch shorter than the stop step: finish the trace so that
            # the capture is written
            try:
                trace.stop()
            except Exception:  # noqa: BLE001 - best-effort finalization
                logger.warning("profiler trace finalization failed")

    if metrics.get("total_loss") is not None:
        # wait for the last step: the caller logs the epoch's wall time next
        float(metrics["total_loss"])
    return steps_run, stopped

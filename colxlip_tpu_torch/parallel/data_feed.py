"""Host batches -> device tensors: port of ``colxlip_tpu/parallel/data_feed.py``.

Each rank's pipeline yields its own rows of the global batch and ships them
to its own device: there is no global array to assemble, so
``global_batch_size`` is the per-rank batch times the group size.

``pack_batch`` fuses a uint8 image batch and its token ids into one
per-sample byte buffer (ids as little-endian uint16 pairs), so a step's
batch crosses PCIe in one copy; ``unpack_batch`` is its inverse in torch on
the device, inside the step. ``DeviceFeeder`` is the ship stage: it stages a
batch in pinned memory and copies it to the device on a stream of its own.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .mesh import world


def global_batch_size(per_device_batch: int) -> int:
    """The global batch: the per-rank batch times the data group's size
    (one device a rank)."""
    return per_device_batch * world()


def pack_batch(images: np.ndarray, texts: np.ndarray) -> np.ndarray:
    """uint8 images [B, ...] and int ids [B, ctx] -> one uint8 buffer
    [B, img_bytes + 2 ctx]. Token ids are below 2**16 (the vocabulary has
    49,408), so each ships as two bytes, low byte first."""
    if images.dtype != np.uint8:
        raise ValueError(
            "packed feed requires a uint8 wire format (--normalize-on-device "
            f"or --ship-format yuv420); got images {images.dtype}")
    b = images.shape[0]
    if texts.shape[0] != b:
        raise ValueError(f"batch mismatch: {images.shape} vs {texts.shape}")
    if texts.min() < 0 or texts.max() >= 1 << 16:
        raise ValueError("token ids must fit uint16 for the packed feed")
    txt_u8 = np.ascontiguousarray(texts.astype("<u2")).view(np.uint8)
    return np.concatenate([images.reshape(b, -1), txt_u8.reshape(b, -1)], axis=1)


def unpack_batch(buf: torch.Tensor, img_shape: Sequence[int], ctx: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, bytes] uint8 -> (images [B, *img_shape] uint8, texts [B, ctx]
    int32) on ``buf``'s device: the ids reassembled as lo | hi << 8 in int32
    (widened before the shift), no bitcast."""
    b = buf.shape[0]
    n_img = int(np.prod(img_shape))
    images = buf[:, :n_img].reshape(b, *img_shape)
    t = buf[:, n_img:].reshape(b, ctx, 2).to(torch.int32)
    return images, t[..., 0] | (t[..., 1] << 8)


class DeviceFeeder:
    """(images, texts) numpy -> tensors on ``device``. With ``packed`` the
    pair becomes one ``pack_batch`` buffer and the call returns (buf, None):
    the train step must be built with the matching ``packed_feed``.

    On a CUDA device each array is staged in pinned memory and copied with
    ``non_blocking=True`` on the feeder's own stream; the call waits for its
    copy (the pinned staging may go after it) and marks the device tensors
    as used by the stream that was current when the feeder was built, so the
    allocator does not reuse their memory while a step still reads them. On
    the CPU the arrays pass through as CPU tensors."""

    def __init__(self, device: Union[str, torch.device], packed: bool = False):
        self.device = torch.device(device)
        self.packed = packed
        self._copy_stream = self._consumer_stream = None
        if self.device.type == "cuda":
            self._consumer_stream = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)

    def _put(self, *arrays: np.ndarray):
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]
        if self._copy_stream is None:
            return host
        with torch.cuda.stream(self._copy_stream):
            pinned = [t.pin_memory() for t in host]
            out = [t.to(self.device, non_blocking=True) for t in pinned]
        self._copy_stream.synchronize()   # the pinned staging may go after this
        for t in out:
            t.record_stream(self._consumer_stream)
        return out

    def __call__(self, images: np.ndarray, texts: np.ndarray
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.packed:
            (buf,) = self._put(pack_batch(images, np.asarray(texts)))
            return buf, None
        images, texts = self._put(images, texts)
        return images, texts

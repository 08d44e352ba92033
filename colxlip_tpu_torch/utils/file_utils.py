"""Remote sync of the log directory: port of ``colxlip_tpu/utils/file_utils.py``.

The training entry point's ``--remote-sync <url>`` copies the run's log
directory (checkpoints, ``out.log``, ``metrics.jsonl``) to ``<url>/<name>``
once at startup, every ``--remote-sync-frequency`` seconds from a thread on
rank 0, and once after the last save has finished. Two protocols, as in the
JAX module:

- ``s3``: ``aws s3 sync <src> <dst> --exact-timestamps`` in a subprocess
  (timeout one hour), in either direction; a missing ``aws``, a timeout or a
  nonzero exit logs an error and returns False;
- ``fsspec``: every file of the local tree ``put`` under the remote root
  (push only; a missing ``fsspec`` returns False).

``get_latest_checkpoint_remote`` (``training/checkpoint.py``) lists the
remote checkpoints for ``--resume latest`` with ``aws s3 ls``.
"""
from __future__ import annotations

import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

SYNC_TIMEOUT_S = 3600


def _s3_sync(src: str, dst: str, what: str) -> bool:
    """One ``aws s3 sync`` in either direction."""
    try:
        result = subprocess.run(["aws", "s3", "sync", src, dst, "--exact-timestamps"],
                                capture_output=True, timeout=SYNC_TIMEOUT_S)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        logger.error("error %s s3: %s", what, e)
        return False
    if result.returncode != 0:
        logger.error("error: %s", result.stderr.decode()[:500])
        return False
    return True


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    return _s3_sync(local_dir, remote_dir, "syncing to")


def remote_sync_pull(remote_dir: str, local_dir: str) -> bool:
    """Fetch one remote checkpoint directory (``--resume latest`` with
    ``--remote-sync``: the restore reads local paths only)."""
    return _s3_sync(remote_dir, local_dir, "fetching from")


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    try:
        import fsspec
    except ImportError:
        logger.error("fsspec not available")
        return False
    try:
        fs, remote_root = fsspec.core.url_to_fs(remote_dir)
        for root, _, files in os.walk(local_dir):
            for fname in files:
                src = os.path.join(root, fname)
                dst = os.path.join(remote_root, os.path.relpath(src, local_dir))
                fs.makedirs(os.path.dirname(dst), exist_ok=True)
                fs.put(src, dst)
        return True
    except Exception as e:  # any backend error is a failed sync, as in the JAX module
        logger.error("error syncing via fsspec: %s", e)
        return False


def remote_sync(local_dir: str, remote_dir: str, protocol: str = "s3") -> bool:
    """One sync of ``local_dir`` to ``remote_dir``."""
    logger.info("Starting remote sync: %s -> %s", local_dir, remote_dir)
    if protocol == "s3":
        return remote_sync_s3(local_dir, remote_dir)
    return remote_sync_fsspec(local_dir, remote_dir)


def start_sync_process(sync_every: int, local_dir: str, remote_dir: str,
                       protocol: str = "s3") -> threading.Thread:
    """A daemon thread that syncs every ``sync_every`` seconds until its
    ``stop_event`` (a ``threading.Event`` attribute) is set."""
    stop_event = threading.Event()

    def loop():
        while not stop_event.wait(sync_every):
            remote_sync(local_dir, remote_dir, protocol)

    t = threading.Thread(target=loop, daemon=True, name="remote-sync")
    t.stop_event = stop_event  # type: ignore[attr-defined]
    t.start()
    return t

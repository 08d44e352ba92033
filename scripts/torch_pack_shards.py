#!/usr/bin/env python3
"""Pack wds tar shards into pre-decoded raw-uint8 shards with the PyTorch
port's packer (``colxlip_tpu_torch/data/pack.py``). The twin of
``scripts/pack_shards.py``: the same flags and the same shards.

    python3 scripts/torch_pack_shards.py --urls '/data/shard-{0000..0099}.tar' \\
        --out-dir /data/packed --size 256 --workers 8

Then train with ``--train-data '/data/packed/shard-{0000..0099}.tar'``.
Host-side only: no device is used.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from colxlip_tpu_torch.data.pack import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())

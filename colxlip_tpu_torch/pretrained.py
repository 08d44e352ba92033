"""Pretrained checkpoint tags: port of ``colxlip_tpu/pretrained.py``.

Named tags such as ``laion400m_e32`` resolve to OpenCLIP checkpoints by URL
(the same registry as the JAX package's), ``hf-hub:org/repo`` through
``huggingface_hub``, and a local path is taken as it is. A download goes to
the cache (``COLXLIP_CACHE``, else ``~/.cache/colxlip_tpu_torch``) through
a temporary file and a rename, happens once, and fails offline with an
error that names the path to place the file at.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_OPENCLIP_BASE = "https://github.com/mlfoundations/open_clip/releases/download"
_HF_BASE = "https://huggingface.co"

# model name -> tag -> url: the subset of the OpenCLIP registry the
# reference recipes use
PRETRAINED: Dict[str, Dict[str, str]] = {
    "ViT-B-32": {
        "openai": f"{_HF_BASE}/timm/vit_base_patch32_clip_224.openai/resolve/main/open_clip_pytorch_model.bin",
        "laion400m_e31": f"{_OPENCLIP_BASE}/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt",
        "laion400m_e32": f"{_OPENCLIP_BASE}/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt",
        "laion2b_s34b_b79k": f"{_HF_BASE}/laion/CLIP-ViT-B-32-laion2B-s34B-b79K/resolve/main/open_clip_pytorch_model.bin",
    },
    "ViT-B-16": {
        "openai": f"{_HF_BASE}/timm/vit_base_patch16_clip_224.openai/resolve/main/open_clip_pytorch_model.bin",
        "laion400m_e31": f"{_OPENCLIP_BASE}/v0.2-weights/vit_b_16-laion400m_e31-00efa78f.pt",
        "laion400m_e32": f"{_OPENCLIP_BASE}/v0.2-weights/vit_b_16-laion400m_e32-55e67d44.pt",
        "laion2b_s34b_b88k": f"{_HF_BASE}/laion/CLIP-ViT-B-16-laion2B-s34B-b88K/resolve/main/open_clip_pytorch_model.bin",
    },
    "ViT-L-14": {
        "openai": f"{_HF_BASE}/timm/vit_large_patch14_clip_224.openai/resolve/main/open_clip_pytorch_model.bin",
        "laion400m_e31": f"{_OPENCLIP_BASE}/v0.2-weights/vit_l_14-laion400m_e31-69988bb6.pt",
        "laion400m_e32": f"{_OPENCLIP_BASE}/v0.2-weights/vit_l_14-laion400m_e32-3d133497.pt",
        "laion2b_s32b_b82k": f"{_HF_BASE}/laion/CLIP-ViT-L-14-laion2B-s32B-b82K/resolve/main/open_clip_pytorch_model.bin",
    },
}

# tags trained with QuickGELU
QUICK_GELU_TAGS = ("openai", "laion400m_e31", "laion400m_e32")


def list_pretrained() -> List[Tuple[str, str]]:
    return [(m, t) for m, tags in PRETRAINED.items() for t in tags]


def get_pretrained_url(model_name: str, tag: str) -> Optional[str]:
    """The URL of (model, tag); ``-colxlip`` and ``-quickgelu`` names reuse
    the base CLIP weights."""
    base = model_name.replace("-colxlip", "").replace("-quickgelu", "")
    return PRETRAINED.get(base, {}).get(tag)


def cache_dir() -> str:
    return os.environ.get("COLXLIP_CACHE", os.path.expanduser("~/.cache/colxlip_tpu_torch"))


def download_pretrained(url: str, dest: Optional[str] = None) -> str:
    """Fetch a checkpoint into the cache (nothing to do if it is there);
    returns its path."""
    import urllib.request

    os.makedirs(cache_dir(), exist_ok=True)
    fname = dest or os.path.join(cache_dir(), os.path.basename(url.split("?")[0]))
    if os.path.exists(fname):
        return fname
    logger.info("downloading %s -> %s", url, fname)
    tmp = fname + ".tmp"
    try:
        urllib.request.urlretrieve(url, tmp)
    except Exception as e:  # any failure of the fetch: name where the file goes
        raise RuntimeError(f"could not download pretrained checkpoint {url!r} (offline "
                           f"environment? place the file at {fname} manually): {e}") from e
    os.replace(tmp, fname)
    return fname


def resolve_pretrained(model_name: str, pretrained: str) -> str:
    """A local path as it is, then ``hf-hub:<repo>``, then a tag of
    ``model_name`` -> the local checkpoint path."""
    if os.path.exists(pretrained):
        return pretrained
    if pretrained.startswith("hf-hub:"):
        repo = pretrained[len("hf-hub:"):]
        try:
            from huggingface_hub import hf_hub_download

            return hf_hub_download(repo, "open_clip_pytorch_model.bin")
        except Exception as e:  # an import or a fetch failure alike
            raise RuntimeError(f"hf-hub download failed for {repo!r} (offline?): {e}") from e
    url = get_pretrained_url(model_name, pretrained)
    if url is None:
        raise FileNotFoundError(
            f"pretrained {pretrained!r} is neither a local path nor a known tag for "
            f"{model_name!r}; known tags: "
            f"{sorted(PRETRAINED.get(model_name.replace('-colxlip', ''), {}))}")
    return download_pretrained(url)

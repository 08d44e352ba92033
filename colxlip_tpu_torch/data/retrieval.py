"""Retrieval evaluation datasets: the seven suites on the unified schema.

Port of ``colxlip_tpu/data/retrieval.py``, with the same readers, the same
``RetrievalExample`` lists and the same dense ground-truth maps (the JAX
docstring cites the reference reader each one mirrors). ``RetrievalSuite``
tokenizes every caption once, orders the unique images by first appearance
and loads them in batches through the eval transform
(``data/transforms.py``), as NHWC float32 numpy arrays: the ``Encoder`` of
``training/evaluate.py`` ships them to the card. The file layouts are those
of ``datasets/EVAL_DATASETS.md``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from .captions import split_caption


@dataclasses.dataclass
class RetrievalExample:
    image: str          # image file path
    caption: str
    image_id: int
    caption_id: int


# ---------------------------------------------------------------------------
# per-suite readers (file layouts identical to the reference)
# ---------------------------------------------------------------------------

def read_coco_pairs(root_dir: str, split: str = "val") -> List[RetrievalExample]:
    """COCO captions (reference data.py:365-399)."""
    annotations_dir = os.path.join(root_dir, "annotations")
    captions_file = os.path.join(annotations_dir, f"captions_{split}2017.json")
    images_dir = os.path.join(root_dir, "images", f"{split}2017")
    with open(captions_file) as f:
        coco = json.load(f)
    id_to_path = {
        im["id"]: os.path.join(images_dir, im["file_name"]) for im in coco["images"]
    }
    out, cap_id = [], 0
    for ann in coco["annotations"]:
        if ann["image_id"] in id_to_path:
            out.append(RetrievalExample(
                image=id_to_path[ann["image_id"]], caption=ann["caption"],
                image_id=ann["image_id"], caption_id=cap_id,
            ))
        cap_id += 1
    return out


def read_flickr_pairs(root_dir: str, split: str = "val") -> List[RetrievalExample]:
    """Flickr30k (reference data.py:427-453): per-image caption lists."""
    base_dir = os.path.dirname(root_dir)
    captions_file = os.path.join(root_dir, f"flickr30k_{split}.json")
    with open(captions_file) as f:
        data = json.load(f)
    out, img_id, cap_id = [], 0, 0
    for ann in data:
        image_path = os.path.join(base_dir, ann["image"])
        for caption in ann["caption"]:
            out.append(RetrievalExample(image_path, caption, img_id, cap_id))
            cap_id += 1
        img_id += 1
    return out


def _read_unified(root_dir: str, captions_file: str) -> List[RetrievalExample]:
    """{'annotations': [{image_id, image, caption}]} schema (DOCCI/Urban1k)."""
    with open(captions_file) as f:
        anns = json.load(f)["annotations"]
    out = []
    for cap_id, ann in enumerate(anns):
        out.append(RetrievalExample(
            image=os.path.join(root_dir, "images", ann["image"]),
            caption=ann["caption"], image_id=ann["image_id"], caption_id=cap_id,
        ))
    return out


def read_docci_pairs(root_dir: str, split: str = "test") -> List[RetrievalExample]:
    """DOCCI (reference data.py:456-476)."""
    assert split == "test"
    return _read_unified(root_dir, os.path.join(root_dir, "annotations", "test_annotations.json"))


def read_urban1k_pairs(root_dir: str, split: str = "test") -> List[RetrievalExample]:
    """Urban1k (reference data.py:479-499)."""
    assert split == "test"
    return _read_unified(root_dir, os.path.join(root_dir, "annotations", "annotations.json"))


def read_sharegpt4v_pairs(
    root_dir: str, json_name: str, total_len: int
) -> List[RetrievalExample]:
    """ShareGPT4V 1k/10k (reference data.py:502-520)."""
    with open(json_name, encoding="utf8") as fp:
        data = json.loads(fp.read(), object_pairs_hook=collections.OrderedDict)[:total_len]
    out = []
    # range(len(data)), not range(total_len): a JSON shorter than the nominal
    # suite size must not IndexError (the reference crashes here,
    # data.py:502-520 — layout parity does not require crash parity)
    for index in range(len(data)):
        caption = data[index]["conversations"][1]["value"]
        rejoined = ". ".join(split_caption(caption))
        image_name = data[index]["image"]
        if "images" in image_name:
            image_name = image_name.replace("/images", "")
        out.append(RetrievalExample(
            image=os.path.join(root_dir, image_name), caption=rejoined,
            image_id=index, caption_id=index,
        ))
    return out


def read_dci_pairs(root_dir: str, split: str = "test") -> List[RetrievalExample]:
    """DCI (reference data.py:523-553): splits.json -> per-file annotations."""
    anno_file = os.path.join(root_dir, "densely_captioned_images", "splits.json")
    with open(anno_file, encoding="utf8") as fp:
        splits = json.load(fp)
    files: List[str] = []
    for v in splits.values():
        files.extend(v)
    image_root = os.path.join(root_dir, "densely_captioned_images", "photos")
    anno_root = os.path.join(root_dir, "densely_captioned_images", "annotations")
    out = []
    for idx, data_file in enumerate(files):
        with open(os.path.join(anno_root, data_file), encoding="utf8") as f:
            anno = json.load(f)
        caption = f"{anno['short_caption']}\n{anno['extra_caption']}"
        out.append(RetrievalExample(
            image=os.path.join(image_root, anno["image"]),
            caption=". ".join(split_caption(caption)),
            image_id=idx, caption_id=idx,
        ))
    return out


def read_iiw_pairs(
    root_dir: str, finegrained: bool = False
) -> List[RetrievalExample]:
    """ImageInWords (reference data.py:556-604), incl. fine-grained mode."""
    if finegrained:
        with open(os.path.join(root_dir, "test_annotations.json")) as f:
            anns = json.load(f)["annotations"]
        return [
            RetrievalExample(
                image=os.path.join(root_dir, a["image"]), caption=a["caption"],
                image_id=a["image_id"], caption_id=a["caption_id"],
            )
            for a in anns
        ]
    data_names = ["DOCCI_Test", "IIW-400", "DCI_Test"]
    data_subroot = {"DOCCI_Test": "docci", "IIW-400": "docci_aar", "DCI_Test": "dci"}
    out, img_id, cap_id = [], 0, 0
    for data_name in data_names:
        anno_file = os.path.join(root_dir, data_name, "data.jsonl")
        with open(anno_file) as f:
            lines = list(f)
        for line in lines:
            d = json.loads(line)
            image_name = d.get("image") or d.get("image/key")
            if ".jpg" not in image_name:
                image_name += ".jpg"
            out.append(RetrievalExample(
                image=os.path.join(root_dir, data_subroot[data_name], image_name),
                caption=". ".join(split_caption(d["IIW"])),
                image_id=img_id, caption_id=cap_id,
            ))
            img_id += 1
            cap_id += 1
    return out


# ---------------------------------------------------------------------------
# suite container
# ---------------------------------------------------------------------------

class RetrievalSuite:
    """Pre-tokenized captions + unique images + dense ground-truth maps.

    Dense indexing: captions keep their list order (0..N-1); unique images are
    ordered by first appearance (0..M-1). img2txt[i] = list of caption idxs;
    txt2img[c] = image idx — the shapes ``compute_retrieval`` consumes
    (reference train.py:457-508 with the remap of :427-454 pre-applied).
    """

    def __init__(self, name: str, data_list: Sequence[RetrievalExample],
                 tokenizer, transform):
        self.name = name
        self.data_list = list(data_list)
        self.transform = transform
        # dense caption ids in list order
        captions = [ex.caption for ex in self.data_list]
        self.tokens = tokenizer(captions) if tokenizer is not None else None
        # unique images by first appearance (reference extract_unique_img_list
        # _from_data_list, data.py:1088-1103)
        self.image_paths: List[str] = []
        img_index: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        self.txt2img: Dict[int, int] = {}
        for cap_idx, ex in enumerate(self.data_list):
            if ex.image_id not in img_index:
                img_index[ex.image_id] = len(self.image_paths)
                self.image_paths.append(ex.image)
            dense_img = img_index[ex.image_id]
            self.img2txt.setdefault(dense_img, []).append(cap_idx)
            self.txt2img[cap_idx] = dense_img

    @property
    def num_texts(self) -> int:
        return len(self.data_list)

    @property
    def num_images(self) -> int:
        return len(self.image_paths)

    def iter_text_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        for i in range(0, self.num_texts, batch_size):
            yield self.tokens[i : i + batch_size]

    def iter_image_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """Batched image loading+preprocessing (fixes data.py:1163-1171)."""
        from PIL import Image

        for i in range(0, self.num_images, batch_size):
            batch = []
            for path in self.image_paths[i : i + batch_size]:
                with Image.open(path) as img:
                    batch.append(self.transform(img))
            yield np.stack(batch)


_READERS: Dict[str, Callable] = {
    "coco": lambda args, **kw: read_coco_pairs(args["root_dir"], args.get("split", "val")),
    "flickr": lambda args, **kw: read_flickr_pairs(args["root_dir"], args.get("split", "val")),
    "docci": lambda args, **kw: read_docci_pairs(args["root_dir"]),
    "urban_1k": lambda args, **kw: read_urban1k_pairs(args["root_dir"]),
    "sharegpt4v-1k": lambda args, **kw: read_sharegpt4v_pairs(
        args["root_dir"], args["json_name"], 1000),
    "sharegpt4v-10k": lambda args, **kw: read_sharegpt4v_pairs(
        args["root_dir"], args["json_name"], 10000),
    "dci": lambda args, **kw: read_dci_pairs(args["root_dir"]),
    "iiw": lambda args, **kw: read_iiw_pairs(
        args["root_dir"], finegrained=args.get("finegrained", False)),
}


def build_retrieval_suite(name: str, reader_args: Dict, tokenizer, transform) -> RetrievalSuite:
    if name not in _READERS:
        raise KeyError(f"unknown retrieval suite {name!r}; have {sorted(_READERS)}")
    data_list = _READERS[name](reader_args)
    return RetrievalSuite(name, data_list, tokenizer, transform)

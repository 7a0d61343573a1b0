"""Dataset factory, the port of `cape_tpu.data.builder` — path resolution
parity with the reference (`datasets/mp100_cape.py:835-962`): images under
`<root>/data`, annotations searched in data/cleaned_annotations ->
clean_annotations -> annotations, file `mp100_split{N}_{split}.json`."""

from __future__ import annotations

import os
from pathlib import Path

from ..config import CAPEConfig
from .mp100 import MP100Dataset
from .tokenizer import DiscreteTokenizer


def resolve_annotation_file(dataset_root: str, split_num: int, image_set: str) -> str:
    root = Path(dataset_root).resolve()
    candidates = [
        root / "data" / "cleaned_annotations" / f"mp100_split{split_num}_{image_set}.json",
        root / "clean_annotations" / f"mp100_split{split_num}_{image_set}.json",
        root / "annotations" / f"mp100_split{split_num}_{image_set}.json",
    ]
    for p in candidates:
        if p.exists():
            return str(p)
    raise FileNotFoundError(
        "Annotation file not found in any location:\n"
        + "\n".join(f"  - {p}" for p in candidates)
    )


def build_mp100_cape(image_set: str, cfg: CAPEConfig) -> MP100Dataset:
    ann_file = resolve_annotation_file(cfg.dataset_root, cfg.mp100_split, image_set)
    img_folder = str(Path(cfg.dataset_root) / "data")
    if not os.path.isdir(img_folder):
        img_folder = cfg.dataset_root
    tokenizer = DiscreteTokenizer(num_bins=cfg.num_bins, seq_len=cfg.seq_len)
    return MP100Dataset(
        img_folder=img_folder,
        ann_file=ann_file,
        tokenizer=tokenizer,
        image_size=cfg.image_size,
        split=image_set,
        image_norm=cfg.image_norm,
        augment=False if cfg.disable_augment else None,
        cache_mb=cfg.data_cache_mb,
        uint8_images=cfg.uint8_transfer,
    )


#: canonical MP-100 split-1 69/10/20 protocol file shipped with the package
#: (category ID lists from the reference's `category_splits.json:1-219`)
CANONICAL_SPLIT1 = str(
    Path(__file__).parent / "category_splits_split1.json"
)


def resolve_split_file(cfg: CAPEConfig) -> str:
    """category_splits.json resolution, in order:

    1. the configured path (as given, then relative to dataset_root);
    2. split 1: the canonical 69/10/20 protocol file shipped in the package;
    3. folds 2-5: synthesized from the fold's annotation JSONs
       (`make_category_split_file`) into the output dir — so the k-fold
       script runs against a dataset root with only annotations present.

    Fallbacks 2/3 apply only when `category_split_file` is still the
    config DEFAULT; an explicitly configured path that does not exist
    raises instead of silently evaluating the wrong protocol.
    """
    for cand in (
        cfg.category_split_file,
        os.path.join(cfg.dataset_root, cfg.category_split_file),
    ):
        if cand and os.path.exists(cand):
            return cand
    if cfg.category_split_file != CAPEConfig().category_split_file:
        raise FileNotFoundError(
            f"category_split_file {cfg.category_split_file!r} not found "
            f"(also tried under dataset_root {cfg.dataset_root!r})"
        )
    if cfg.mp100_split == 1:
        return CANONICAL_SPLIT1
    from .splits import make_category_split_file

    out = os.path.join(
        cfg.output_dir, f"category_splits_split{cfg.mp100_split}.json"
    )
    if not os.path.exists(out):
        make_category_split_file(cfg.dataset_root, cfg.mp100_split, out)
        print(f"Synthesized category split file for fold {cfg.mp100_split}: "
              f"{out}", flush=True)
    return out

"""GT annotation visualization: the port of
`scripts/visualize_gt_annotations.py`. Draws keypoints + skeletons on the
raw image (with its bbox) and on the preprocessed (bbox-cropped, resized)
record side by side, one PNG per image. Drawing needs cv2; nothing runs
on the card.

    python -m cape_tpu_torch.cli.visualize_gt_annotations --dataset_root ... \
        --split train --num_images 8 --output_dir gt_viz/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GT annotation visualization (PyTorch port)")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--mp100_split", type=int, default=1)
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--num_images", type=int, default=8)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--output_dir", default="gt_viz")
    return p


def main(argv=None):
    """Write the panels; returns the paths written."""
    args = get_args_parser().parse_args(argv)

    from ..config import CAPEConfig
    from ..data.builder import build_mp100_cape
    from ..data.image import decode_rgb
    from ..data.mp100 import image_to_uint8
    from .visualize import _cv2, _draw_pose

    cv2 = _cv2()
    cfg = CAPEConfig(dataset_root=args.dataset_root,
                     mp100_split=args.mp100_split,
                     image_size=args.image_size)
    ds = build_mp100_cape(args.split, cfg)
    ds.augment = False  # show deterministic preprocessing
    os.makedirs(args.output_dir, exist_ok=True)

    rng = np.random.default_rng(0)
    written = []
    for i in range(min(args.num_images, len(ds))):
        # raw image + annotation
        img_id = ds.ids[i]
        info = ds.coco.load_img(img_id)
        raw = decode_rgb(os.path.join(ds.root, info["file_name"]))[..., ::-1]
        ann = ds.coco.load_anns(img_id)[0]
        kpts3 = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        # category_skeleton already normalizes COCO 1-indexed edges to 0
        skel0 = ds.coco.category_skeleton(ann["category_id"])
        raw_panel = _draw_pose(np.ascontiguousarray(raw), kpts3[:, :2], skel0,
                               kpts3[:, 2], (0, 255, 0))
        bx, by, bw, bh = [int(v) for v in ann["bbox"]]
        cv2.rectangle(raw_panel, (bx, by), (bx + bw, by + bh), (0, 0, 255), 2)

        # preprocessed record
        rec = ds.get_record(i, rng)
        proc = image_to_uint8(rec["image"])[..., ::-1]
        proc_panel = _draw_pose(np.ascontiguousarray(proc), rec["keypoints"],
                                skel0, rec["visibility"], (0, 255, 0))

        h = max(raw_panel.shape[0], proc_panel.shape[0])

        def pad(x):
            return np.pad(x, ((0, h - x.shape[0]), (0, 0), (0, 0)))
        canvas = np.concatenate([pad(raw_panel), pad(proc_panel)], axis=1)
        out = os.path.join(args.output_dir,
                           f"gt_{args.split}_{img_id}_cat{ann['category_id']}.png")
        cv2.imwrite(out, canvas)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()

"""Preprocessing audit visualization: the port of
`scripts/visualize_gt_preprocessing.py`. Original -> bbox crop -> resize
-> augmented, keypoints + skeleton overlaid on every stage, four panels
per image:

    ORIGINAL+BBOX | CROP | RESIZE (eval path) | AUGMENTED (train path)

Works on the real MP-100 tree or the synthetic fixture
(`data.synthetic.make_synthetic_mp100`): `--synthetic` generates one in a
temporary directory and audits that. Drawing and augmentation need cv2;
nothing runs on the card.

    python -m cape_tpu_torch.cli.visualize_gt_preprocessing \
        --dataset_root ... --split train --num_images 8 \
        --output_dir preproc_viz/
    python -m cape_tpu_torch.cli.visualize_gt_preprocessing --synthetic
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_preprocessing_panels(ds, index: int, rng: np.random.Generator,
                                augment_rng: np.random.Generator):
    """Build the 4-stage panel row for one dataset record.

    Returns (canvas uint8 BGR, img_id, category_id).
    """
    from ..data.augment import resize_with_keypoints, train_augment
    from ..data.image import decode_rgb
    from ..data.mp100 import image_to_uint8
    from .visualize import _cv2, _draw_pose

    cv2 = _cv2()
    img_id = ds.ids[index]
    info = ds.coco.load_img(img_id)
    raw = decode_rgb(os.path.join(ds.root, info["file_name"]))[..., ::-1]
    # the same first-valid-instance selection + crop the loader applies
    crop, kpts_crop, visibility, ann, bw, bh = ds._load_crop(img_id)
    skel0 = ds.coco.category_skeleton(ann["category_id"])

    # stage 1: original image, original-frame keypoints + bbox rectangle
    kpts3 = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
    p_orig = _draw_pose(np.ascontiguousarray(raw), kpts3[:, :2], skel0,
                        kpts3[:, 2], (0, 255, 0))
    bx, by, bww, bhh = [int(v) for v in ann["bbox"]]
    cv2.rectangle(p_orig, (bx, by), (bx + bww, by + bhh), (0, 0, 255), 2)

    # stage 2: bbox crop, keypoints shifted into the crop frame
    p_crop = _draw_pose(np.ascontiguousarray(crop[..., ::-1]), kpts_crop,
                        skel0, visibility, (0, 255, 0))

    # stage 3: deterministic resize (the val/test path)
    res_img, res_kpts = resize_with_keypoints(
        crop.copy(), kpts_crop.copy(), ds.image_size)
    p_res = _draw_pose(image_to_uint8(res_img)[..., ::-1], res_kpts, skel0,
                       visibility, (0, 255, 0))

    # stage 4: full train augmentation (affine/flip/color/noise + resize)
    aug_img, aug_kpts = train_augment(
        crop.copy(), kpts_crop.copy(), ds.image_size, augment_rng)
    p_aug = _draw_pose(image_to_uint8(aug_img)[..., ::-1], aug_kpts, skel0,
                       visibility, (0, 255, 0))

    panels = [(p_orig, "ORIGINAL+BBOX"), (p_crop, "CROP"),
              (p_res, "RESIZE"), (p_aug, "AUGMENTED")]
    h = max(p.shape[0] for p, _ in panels)
    cols = []
    for p, label in panels:
        p = np.ascontiguousarray(p)
        cv2.putText(p, label, (4, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                    (255, 255, 255), 1)
        cols.append(np.pad(p, ((0, h - p.shape[0]), (0, 8), (0, 0))))
    return np.concatenate(cols, axis=1), img_id, ann["category_id"]


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Preprocessing audit visualization (PyTorch port)")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="generate + audit the synthetic fixture")
    p.add_argument("--mp100_split", type=int, default=1)
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--num_images", type=int, default=8)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", default="preproc_viz")
    return p


def main(argv=None):
    """Write the panels; returns the paths written."""
    args = get_args_parser().parse_args(argv)

    from ..config import CAPEConfig
    from ..data.builder import build_mp100_cape
    from .visualize import _cv2

    cv2 = _cv2()
    if args.synthetic:
        import tempfile

        from ..data.synthetic import make_synthetic_mp100

        tmp = tempfile.mkdtemp(prefix="cape_preproc_viz_")
        make_synthetic_mp100(tmp, learnable=True)
        args.dataset_root = tmp
        args.image_size = min(args.image_size, 128)
    assert args.dataset_root, "--dataset_root or --synthetic required"

    cfg = CAPEConfig(dataset_root=args.dataset_root,
                     mp100_split=args.mp100_split,
                     image_size=args.image_size)
    ds = build_mp100_cape(args.split, cfg)
    os.makedirs(args.output_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    augment_rng = np.random.default_rng(args.seed + 1)
    written = []
    for i in range(min(args.num_images, len(ds))):
        canvas, img_id, cid = render_preprocessing_panels(
            ds, i, rng, augment_rng)
        out = os.path.join(
            args.output_dir,
            f"preproc_{args.split}_{img_id}_cat{cid}.png")
        cv2.imwrite(out, canvas)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()

"""Serving API: raw images + a support prototype -> pixel keypoints. The
port of `cape_tpu.serve`.

`CAPEPredictor.predict()` takes raw RGB images and a support-keypoint
prototype and returns pixel keypoints in the original image frame:

- host preprocessing: optional bbox crop, resize to the model's square
  input, shipped as uint8 (the model normalizes on the device);
- requests pad to a fixed `batch_size` (padding rows are dropped from the
  results), so every decode runs at one shape;
- one batched autoregressive decode on the card (`eval.evaluate.decode`:
  replays of the CUDA graphs captured at the first request of the
  batch's shape, one host read per `models.cape.DECODE_CHUNK` tokens);
- host postprocessing: trim to the category keypoint count, map back
  through resize + crop into original pixel coordinates.

A request is the root span `serve.predict` (`trace`), with `serve.prepare`
(one image's crop and resize), and per batch `serve.batch` (stack and
pad), the decode's spans, `serve.fetch` (the host waits for the card's
outputs) and `serve.extract` (keypoints and pixel mapping).

`CAPEPredictor.from_checkpoint` loads a checkpoint the port's training
loop wrote (`utils.checkpoint`: the config from `meta.json`, the fp32
masters from `state.pt`); weights may also come from
`convert.from_jax_params` or a seeded initialisation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import trace
from .config import CAPEConfig
from .data.augment import resize_with_keypoints
from .data.mp100 import clamp_bbox
from .data.token_types import TokenType
from .device import DeviceLike, resolve_device
from .eval.evaluate import decode, extract_pred_keypoints
from .models.cape import CAPE
from .utils.checkpoint import config_of, load_weights


class CAPEPredictor:
    """Category-agnostic pose estimation on raw images.

    Usage:
        predictor = CAPEPredictor.from_checkpoint("output/.../best_...")
        # or CAPEPredictor(cfg, CAPE(cfg)), on the card
        results = predictor.predict(
            images=[img_hwc_uint8, ...],          # raw RGB
            support_coords=proto,                  # (N, 2) in [0, 1]
            skeleton=[[0, 1], [1, 2], ...],        # 0-indexed edges
            bboxes=[(x, y, w, h), ...],            # optional crops
        )
        results[i]["keypoints"]  # (N, 2) pixels in the original frame
    """

    def __init__(self, cfg: CAPEConfig, model: CAPE, batch_size: int = 8,
                 device: DeviceLike = None):
        self.cfg = cfg.replace(dropout=0.0)
        if model.cfg.replace(dropout=0.0) != self.cfg:
            raise ValueError("the model was built from another config")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = max(1, batch_size)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, checkpoint: str, batch_size: int = 8,
                        device: DeviceLike = None) -> "CAPEPredictor":
        """Load a self-describing checkpoint directory (epoch_N / best_*):
        the model is rebuilt from its config on `device` (the card unless
        the caller asks for the CPU) and takes its fp32 masters."""
        cfg = config_of(checkpoint)
        model = CAPE(cfg, device=device)
        load_weights(model, checkpoint)
        return cls(cfg, model, batch_size=batch_size, device=device)

    # ------------------------------------------------------------------
    def _prepare(self, image: np.ndarray, bbox) -> Dict:
        """Crop/resize one image; return model input + the inverse map."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 RGB image, got {img.dtype}")
        with trace.span("serve.prepare"):
            H, W = img.shape[:2]
            if bbox is not None:
                bx, by, bw, bh = clamp_bbox(bbox, W, H)
                img = img[by: by + bh, bx: bx + bw]
            else:
                bx, by, bw, bh = 0, 0, W, H
            S = self.cfg.image_size
            resized, _ = resize_with_keypoints(img, np.zeros((0, 2)), S)
        # ship uint8; the model normalizes on device
        # inverse map: model [0,1] coords -> original pixels
        return {
            "input": resized,
            "origin": (float(bx), float(by)),
            "scale": (bw / float(S), bh / float(S)),
        }

    def predict(
        self,
        images: Sequence[np.ndarray],
        support_coords: np.ndarray,
        skeleton: Optional[Sequence[Sequence[int]]] = None,
        support_visibility: Optional[np.ndarray] = None,
        bboxes: Optional[Sequence] = None,
    ) -> List[Dict]:
        """Predict keypoints for a batch of query images of ONE category.

        Args:
            images: raw (H, W, 3) uint8 RGB images (any sizes).
            support_coords: category prototype in [0, 1] — (N, 2) for
                1-shot, or (K_shots, N, 2) for the K-shot protocol
                (mean-pool of coords + `any` of masks).
            skeleton: 0-indexed edge list (optional).
            support_visibility: COCO flags, (N,) or (K_shots, N) matching
                `support_coords`; default all-visible.
            bboxes: per-image (x, y, w, h) instance boxes (optional).
        Returns:
            per image: dict(keypoints (N, 2) float64 pixels in the ORIGINAL
            frame, generated (N,) bool — False rows are zero-padded because
            the model stopped early, length int).
        """
        with trace.span("serve.predict", root=True):
            return self._predict(images, support_coords, skeleton,
                                 support_visibility, bboxes)

    def _predict(self, images, support_coords, skeleton, support_visibility,
                 bboxes) -> List[Dict]:
        cfg = self.cfg
        sc = np.asarray(support_coords, np.float32)
        if sc.ndim == 2:
            sc = sc[None]                                   # 1-shot
        if sc.ndim != 3 or sc.shape[-1] != 2:
            raise ValueError(
                f"support_coords must be (N, 2) or (K, N, 2), got {sc.shape}")
        shots, N = sc.shape[0], sc.shape[1]
        K = cfg.max_support_keypoints
        if N > K:
            raise ValueError(f"{N} support keypoints > static max {K}")
        if bboxes is not None and len(bboxes) != len(images):
            raise ValueError("bboxes length must match images")

        vis = (np.full((shots, N), 2) if support_visibility is None
               else np.asarray(support_visibility))
        if vis.ndim == 1:
            vis = np.broadcast_to(vis, (shots, N))
        if vis.shape != (shots, N):
            raise ValueError(
                f"support_visibility {vis.shape} must match "
                f"support_coords shots/keypoints ({shots}, {N})")

        # K-shot aggregation, exactly as the training/eval collate:
        # mean over shot coords, `any` over True=ignore masks
        per_shot_coords = np.zeros((shots, K, 2), np.float32)
        per_shot_coords[:, :N] = np.clip(sc, 0.0, 1.0)
        per_shot_mask = np.ones((shots, K), bool)
        per_shot_mask[:, :N] = vis == 0
        coords = per_shot_coords.mean(axis=0)
        mask = per_shot_mask.any(axis=0)

        edges = np.full((cfg.max_skeleton_edges, 2), -1, np.int32)
        if skeleton:
            se = np.asarray(list(skeleton), np.int32)[: cfg.max_skeleton_edges]
            edges[: len(se)] = se

        prepped = [
            self._prepare(img, bboxes[i] if bboxes is not None else None)
            for i, img in enumerate(images)
        ]

        results: List[Dict] = []
        B = self.batch_size
        # support prototype is shared by every chunk — broadcast once
        coords_b = np.ascontiguousarray(np.broadcast_to(coords, (B,) + coords.shape))
        mask_b = np.ascontiguousarray(np.broadcast_to(mask, (B,) + mask.shape))
        edges_b = np.ascontiguousarray(np.broadcast_to(edges, (B,) + edges.shape))
        for start in range(0, len(prepped), B):
            with trace.span("serve.batch"):
                chunk = prepped[start: start + B]
                n_real = len(chunk)
                while len(chunk) < B:  # pad to the fixed batch size
                    chunk.append(chunk[-1])
                batch_imgs = np.stack([c["input"] for c in chunk])
            out = decode(self.model, batch_imgs, coords_b, mask_b, edges_b)
            with trace.span("serve.fetch"):
                logits = out["pred_logits"].cpu().numpy()
                pcoords = out["pred_coords"].cpu().numpy()
                lengths = out["lengths"].cpu().numpy()
            with trace.span("serve.extract"):
                active = (np.arange(logits.shape[1])[None, :]
                          < lengths[:, None])
                kpts = extract_pred_keypoints(
                    logits, pcoords, active, np.full((B,), N))
                gen = [
                    (np.arange(N) < int(
                        ((logits[i].argmax(-1) == TokenType.coord)
                         & active[i]).sum()))
                    for i in range(B)
                ]
                for i in range(n_real):
                    ox, oy = chunk[i]["origin"]
                    sx, sy = chunk[i]["scale"]
                    pix = kpts[i].astype(np.float64) * cfg.image_size
                    pix[:, 0] = pix[:, 0] * sx + ox
                    pix[:, 1] = pix[:, 1] * sy + oy
                    results.append({
                        "keypoints": pix,
                        "generated": gen[i],
                        "length": int(lengths[i]),
                    })
        return results

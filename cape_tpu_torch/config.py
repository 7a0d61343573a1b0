"""Typed configuration, a copy of `cape_tpu.config` for the PyTorch port.

Same fields, defaults and JSON as the JAX package's `CAPEConfig`, so one
config file reads in both packages; the port keeps its own copy because it
imports nothing of `cape_tpu`. Fields that only the JAX package reads
(mesh, remat, profile_dir, ...) are kept for that round trip.

Replaces the reference's ~90-flag argparse namespace
(`models/train_cape_episodic.py:86-254`) with a JSON-serializable dataclass.
Checkpoints embed the config so they are self-describing (parity with the
reference pickling `args` into checkpoints, `train_cape_episodic.py:870`).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class CAPEConfig:
    """Full model + training + data configuration.

    Defaults mirror the reference training CLI defaults
    (`models/train_cape_episodic.py:86-254`) unless noted.

    Frozen (immutable + hashable): a CAPE module is then hashable too, so
    jitted functions taking the module as a static argument cache across
    calls (e.g. the eval decode is compiled once per model, not once per
    validation epoch). Use `.replace(...)` to derive variants.
    """

    # ---- episodic parameters ----
    num_queries_per_episode: int = 2
    num_support_per_episode: int = 1          # K-shot
    episodes_per_epoch: int = 1000
    val_episodes_per_epoch: int = 200
    # Episodes per eval/validation decode batch. The reference evaluates one
    # episode at a time (`eval_cape_checkpoint.py:296-303`) because torch
    # ragged shapes force it; our episodes are fixed-shape so the decode is
    # batch-parallel — on an N-chip mesh a batch of N shards one episode per
    # chip instead of replicating batch-1 work N times.
    eval_batch_size: int = 8
    fixed_val_episodes: bool = True
    val_seed: int = 42
    category_split_file: str = "category_splits.json"

    # ---- support encoder (geometric) ----
    support_encoder_layers: int = 3
    support_fusion_method: str = "cross_attention"
    use_geometric_encoder: bool = True        # the CapeX-style encoder is the shipped path
    use_gcn_preenc: bool = True
    num_gcn_layers: int = 2
    max_support_keypoints: int = 100          # static pad size for support sets
    max_skeleton_edges: int = 128             # static pad size for skeleton edge lists

    # ---- optimization ----
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    lr_linear_proj_mult: float = 0.1          # applied to deformable sampling offsets
    batch_size: int = 2                       # episodes per batch
    accumulation_steps: int = 4
    weight_decay: float = 1e-4
    epochs: int = 300
    scheduler: str = "cosine_warmrestarts"    # multistep | cosine_warmrestarts | onecycle
    lr_drop_epochs: Tuple[int, ...] = (200, 250)
    warmup_epochs: int = 5
    t0: int = 20                              # cosine warm-restart initial period
    t_mult: int = 2
    eta_min: float = 1e-6
    early_stopping_patience: int = 20
    clip_max_norm: float = 0.1

    # ---- input ----
    input_channels: int = 3
    image_size: int = 512                     # post-resize square size (aug pipeline, mp100_cape.py:940)
    image_norm: bool = False                  # ImageNet mean/std normalization
    # Ship images host->device as uint8 and normalize on device (4x fewer
    # H2D bytes than the reference's host-side float conversion,
    # mp100_cape.py:437-444). The model accepts either dtype; float input
    # is assumed host-normalized. Measured: the float32 batch transfer was
    # the sustained-training bottleneck (PERF.md round 3, 2026-08-18).
    uint8_transfer: bool = True

    # ---- backbone ----
    backbone: str = "resnet50"
    dilation: bool = False
    position_embedding: str = "sine"
    num_feature_levels: int = 4

    # ---- transformer ----
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    dec_n_points: int = 4
    enc_n_points: int = 4
    query_pos_type: str = "sine"
    with_poly_refine: bool = True
    # Decoder layer variant (`train_cape_episodic.py:220-222` flags /
    # `deformable_transformer_v2.py:76-115` dispatch). v1 is the CAPE
    # flagship; v2-v6/v41 are the reference's experimental support-free
    # layers — teacher-forced training only, exactly as in the reference
    # (its decode path crashes for them; ours rejects loudly).
    dec_layer_type: str = "v1"
    dec_attn_concat_src: bool = False
    dec_qkv_proj: bool = True

    # ---- sequence / vocab ----
    seq_len: int = 200
    vocab_size: int = 2000                    # num_bins = int(sqrt(vocab_size)) = 44
    min_decode_len: int = 6                   # EOS suppressed before this step (roomformer_v2.py:460)

    # ---- loss ----
    aux_loss: bool = True
    cls_loss_coef: float = 1.0
    coords_loss_coef: float = 5.0
    eos_weight: float = 20.0
    label_smoothing: float = 0.0

    # ---- dataset ----
    dataset_name: str = "mp100"
    dataset_root: str = ""
    mp100_split: int = 1

    # ---- runtime ----
    seed: int = 42
    output_dir: str = "output/cape_episodic"
    bf16: bool = True                         # run compute in bfloat16 on TPU
    num_data_threads: int = 2
    # host-loader LRU budget (MB) per dataset: decoded bbox crops (train —
    # skips PNG decode on episodic revisits) and final records (the
    # deterministic no-augment path: fixed-episode validation is ~free
    # after its first epoch). 0 disables.
    data_cache_mb: int = 1024
    mesh_shape: Tuple[int, ...] = (-1,)       # data-parallel axis, -1 = all devices
    mesh_axis_names: Tuple[str, ...] = ("data",)
    # Train steps fused into ONE device dispatch (`lax.scan` over stacked
    # batches). >1 amortizes per-dispatch launch latency across N real
    # optimizer steps — decisive when the host<->device link is slow (a
    # remote/relay-attached TPU) and a steady win on direct-attached
    # hardware. 1 = classic one-dispatch-per-step.
    steps_per_dispatch: int = 1

    # ---- pallas kernels ----
    # The whole-op MSDA forward kernel (ops/msda_kernel.py) in place of the
    # per-level core. The core's own formulation is not a config field:
    # environment variables select it (the route table of ops/msda.py).
    use_pallas_msda: bool = False

    # ---- memory ----
    # jax.checkpoint the encoder layers. None = auto: off for small
    # per-device batches (skipping the backward recompute is a measured
    # 24% step win at B=4/512px), on above batch*(size/512)^2 > 8 where
    # the no-remat activation footprint fails to compile on a 16 GB v5e.
    remat_encoder: Optional[bool] = None
    remat_decoder: bool = False               # jax.checkpoint decoder layers

    # ---- weights ----
    resnet_weights: str = ""                  # optional torchvision resnet50 .npz
    # Freeze backbone norm affines (the reference's FrozenBatchNorm). Only
    # sensible with pretrained weights; from scratch the zero-init residual
    # scales must train or every bottleneck's residual branch is dead.
    # None = auto: freeze iff resnet_weights provided.
    freeze_backbone_affine: Optional[bool] = None

    # ---- observability ----
    profile_dir: str = ""                     # xprof trace dir ("" = off)

    # ---- debug / overfit (train_cape_episodic.py:120-126) ----
    debug_overfit_category: int = -1          # -1 = off; else single category id
    debug_overfit_episodes: int = 10
    debug_single_image: bool = False          # support == query image
    disable_augment: bool = False             # turn off train augmentation

    # ------------------------------------------------------------------
    @property
    def num_bins(self) -> int:
        """Grid resolution per axis. `mp100_cape.py:118-121`."""
        return int(math.isqrt(self.vocab_size))

    @property
    def use_remat_encoder(self) -> bool:
        """Resolved encoder-remat policy (see `remat_encoder`)."""
        if self.remat_encoder is not None:
            return self.remat_encoder
        return self.batch_size * (self.image_size / 512) ** 2 > 8

    @property
    def token_vocab_size(self) -> int:
        """num_bins^2 grid cells + BOS/EOS/SEP/PAD (`discrete_tokenizer.py:20-28`)."""
        return self.num_bins * self.num_bins + 4

    @property
    def num_token_classes(self) -> int:
        """Token-type classes predicted by the class head: coord/sep/eos."""
        return 3

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CAPEConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in known}
        for f in dataclasses.fields(cls):
            if f.name in kwargs and isinstance(f.default, tuple):
                kwargs[f.name] = tuple(kwargs[f.name])
        return cls(**kwargs)

    def replace(self, **kwargs) -> "CAPEConfig":
        return dataclasses.replace(self, **kwargs)


def tiny_test_config(**overrides) -> CAPEConfig:
    """A miniature config for unit tests: small images, few layers.

    Keeps every architectural feature enabled so tests cover the real code
    paths, just at toy sizes.
    """
    base = dict(
        image_size=64,
        hidden_dim=64,
        dim_feedforward=128,
        enc_layers=2,
        dec_layers=2,
        nheads=4,
        seq_len=24,
        vocab_size=100,               # num_bins = 10
        max_support_keypoints=12,
        max_skeleton_edges=16,
        support_encoder_layers=1,
        num_gcn_layers=1,
        episodes_per_epoch=4,
        val_episodes_per_epoch=2,
        batch_size=1,
        accumulation_steps=1,
        epochs=2,
        warmup_epochs=0,
        min_decode_len=2,
        bf16=False,
        dropout=0.0,
        backbone="resnet_tiny",
    )
    base.update(overrides)
    return CAPEConfig(**base)

"""CAPE model: backbone -> deformable encoder -> support-conditioned causal
decoder, plus the autoregressive decode loop: the port of
`cape_tpu.models.cape`.

- One module, one parameter set, built and initialised on an explicit
  device from an explicit `torch.Generator` (seeded by `cfg.seed` when none
  is given).
- Compute dtype: bf16 when `cfg.bf16`, with the JAX package's fp32
  islands kept in fp32 (the sampling-offset projections and the decoder's
  anchor embedding; see `_cast`). The module's parameters are in the
  compute dtype; training keeps fp32 masters of them in the optimizer
  (`train.state`), as flax keeps fp32 parameters and computes in bf16.
- `forward` is the teacher-forced training call; dropout draws from the
  `torch.Generator` it is given, and `generator=None` is deterministic.
- `autoregressive_decode` generates up to `seq_len` tokens with static KV
  caches and on-device re-tokenization and token-type branching, exiting
  once every sample has emitted EOS. The JAX `while_loop` becomes a Python
  loop here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..config import CAPEConfig
from ..data.mp100 import IMAGENET_MEAN, IMAGENET_STD
from ..data.token_types import TokenType
from ..data.tokenizer import DiscreteTokenizer
from ..device import DeviceLike, resolve_device
from .backbone import ResNet50
from .decoder import Decoder
from .deformable import DeformableEncoder, MSDeformAttn
from .layers import default_init_, normal_, xavier_uniform_, zeros_
from .position_encoding import image_sine_pe_2d
from .support_encoder import GeometricSupportEncoder


def level_shapes(image_size: int, num_levels: int,
                 dilation: bool = False) -> Tuple[Tuple[int, int], ...]:
    """Static feature-map shapes: strides 8/16/32 (+64 for the extra level
    projected from layer4). DC5 dilation keeps layer4 at stride 16, so the
    strides become 8/16/16 (+32)."""
    strides = [8, 16, 16, 32] if dilation else [8, 16, 32, 64]
    return tuple((image_size // s, image_size // s)
                 for s in strides[:num_levels])


def _unsupported(cfg: CAPEConfig) -> Optional[str]:
    """The config options the port does not have (yet)."""
    if cfg.support_fusion_method != "cross_attention":
        return (f"support_fusion_method={cfg.support_fusion_method!r}: only "
                "'cross_attention' is functional (matches the reference)")
    if cfg.position_embedding not in ("sine", "v2"):
        return (f"position_embedding={cfg.position_embedding!r}: the port "
                "has the sine encoding only")
    if not cfg.use_geometric_encoder:
        return "use_geometric_encoder=False (SupportPoseGraphEncoder) is not ported"
    if cfg.dec_layer_type != "v1":
        return (f"dec_layer_type={cfg.dec_layer_type!r}: the port has the v1 "
                "decoder layer only")
    if cfg.dec_attn_concat_src:
        return ("dec_attn_concat_src (a train-only option of the JAX "
                "package) is not ported yet: it is queued in ROADMAP.md")
    if not cfg.dec_qkv_proj:
        return ("dec_qkv_proj=False (identity q/k/v pre-projections, a "
                "train-only option) is not ported yet: it is queued in "
                "ROADMAP.md")
    return None


class CAPE(nn.Module):
    """Full category-agnostic pose estimation model."""

    def __init__(self, cfg: CAPEConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        why = _unsupported(cfg)
        if why:
            raise ValueError(why)
        device = resolve_device(device)
        self.cfg = cfg
        blocks = (1, 1, 1, 1) if cfg.backbone == "resnet_tiny" else (3, 4, 6, 3)
        self.backbone = ResNet50(cfg.input_channels, blocks, cfg.dilation)
        d = cfg.hidden_dim
        # 1x1 conv + GroupNorm(32) per backbone level; extra stride-2 3x3
        # level from layer4 (`roomformer_v2.py:186-214`)
        self.input_projs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, d, 1), nn.GroupNorm(32, d, eps=1e-5))
             for c in (512, 1024, 2048)]
            + [nn.Sequential(nn.Conv2d(2048, d, 3, stride=2, padding=1),
                             nn.GroupNorm(32, d, eps=1e-5))])
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d))
        self.encoder = DeformableEncoder(
            cfg.enc_layers, d, cfg.dim_feedforward, dropout=cfg.dropout,
            n_levels=cfg.num_feature_levels, n_heads=cfg.nheads,
            n_points=cfg.enc_n_points, remat=cfg.use_remat_encoder,
            use_pallas=cfg.use_pallas_msda)
        self.decoder = Decoder(
            cfg.dec_layers, d, cfg.dim_feedforward, dropout=cfg.dropout,
            n_levels=cfg.num_feature_levels, n_heads=cfg.nheads,
            n_points=cfg.dec_n_points, vocab_size=cfg.token_vocab_size,
            seq_len=cfg.seq_len, num_classes=cfg.num_token_classes,
            pad_id=cfg.num_bins * cfg.num_bins + 3,
            use_pallas=cfg.use_pallas_msda, query_pos_type=cfg.query_pos_type,
            poly_refine=cfg.with_poly_refine)
        self.support_encoder = GeometricSupportEncoder(
            d, cfg.support_encoder_layers, cfg.nheads, cfg.dim_feedforward,
            dropout=cfg.dropout, use_gcn=cfg.use_gcn_preenc,
            num_gcn_layers=cfg.num_gcn_layers,
            max_seq_pe=max(cfg.max_support_keypoints, 100))
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        default_init_(self, generator)
        self.to(device)
        self._cast(torch.bfloat16 if cfg.bf16 else torch.float32)
        self._pe_cache: Dict[Tuple, torch.Tensor] = {}
        self.eval()

    def init_weights(self, g: torch.Generator) -> None:
        for proj in self.input_projs:
            xavier_uniform_(proj[0].weight, g)
            zeros_(proj[0].bias)
        normal_(self.level_embed, 1.0, g)

    def _cast(self, dtype: torch.dtype) -> None:
        """Cast to the compute dtype, keeping the fp32 islands in fp32."""
        self.to(dtype)
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                m.sampling_offsets.float()
        self.decoder.query_embed.data = self.decoder.query_embed.data.float()

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.level_embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.level_embed.dtype

    @property
    def spatial_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return level_shapes(self.cfg.image_size, self.cfg.num_feature_levels,
                            self.cfg.dilation)

    def _level_pe(self, h: int, w: int) -> torch.Tensor:
        """(h*w, D) sine positional encoding of one level, cached."""
        key = (h, w, self.dtype, self.device)
        pe = self._pe_cache.get(key)
        if pe is None:
            pe = torch.as_tensor(
                image_sine_pe_2d(h, w, self.cfg.hidden_dim).reshape(h * w, -1),
                device=self.device).to(self.dtype)
            self._pe_cache[key] = pe
        return pe

    def encode_image(self, images: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(B, S, S, 3) uint8 or float32 NHWC -> (B, sum(Hl*Wl), D) memory.

        uint8 input is normalized on the device in fp32 (/255, then the
        ImageNet mean/std when `cfg.image_norm`) before the cast to the
        compute dtype; float input is assumed host-normalized. The NHWC
        input is converted to NCHW once, here.
        """
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
            if self.cfg.image_norm:
                mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
                std = torch.as_tensor(IMAGENET_STD, device=images.device)
                images = (images - mean) / std
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        feats = self.backbone(x)
        srcs = [self.input_projs[i](feats[i]) for i in range(3)]
        if self.cfg.num_feature_levels > 3:
            srcs.append(self.input_projs[3](feats[-1]))
        return self.encode_features(srcs, generator)

    def encode_features(self, srcs,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Post-projection NCHW levels (B, D, Hl, Wl) -> encoder memory.

        Each level flattens row-major to (B, Hl*Wl, D), the JAX package's
        order, and gets its sine PE plus `level_embed`.
        """
        flat, pos_flat = [], []
        for lvl, src in enumerate(srcs):
            b, d, h, w = src.shape
            lvl_pos = self._level_pe(h, w) + self.level_embed[lvl]
            flat.append(src.flatten(2).transpose(1, 2))
            pos_flat.append(lvl_pos.expand(b, h * w, d))
        src_flat = torch.cat(flat, dim=1)
        pos = torch.cat(pos_flat, dim=1)
        return self.encoder(src_flat, pos, self.spatial_shapes, generator)

    def encode_support(self, coords, mask, skeleton_edges,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        return self.support_encoder(coords.to(self.dtype), mask,
                                    skeleton_edges, generator)

    # ------------------------------------------------------------------
    def forward(self, images, support_coords, support_mask, skeleton_edges,
                targets: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced training forward (`CAPE.__call__` of the JAX
        package). `generator` draws the dropout masks on the model's
        device; None is `deterministic=True`.

        Returns dict: pred_logits (B, L, 3), pred_coords (B, L, 2),
        aux_classes/aux_coords (num_layers-1, B, L, ...) when aux_loss; all
        fp32.
        """
        memory = self.encode_image(images, generator)
        support = self.encode_support(support_coords, support_mask,
                                      skeleton_edges, generator)
        seq_kwargs = {k: targets[k] for k in (
            "seq11", "seq12", "seq21", "seq22",
            "delta_x1", "delta_x2", "delta_y1", "delta_y2")}
        classes, refs = self.decoder.forward_train(
            seq_kwargs, memory, self.spatial_shapes, support, support_mask,
            generator)
        out = {"pred_logits": classes[-1].float(),
               "pred_coords": refs[-1].float()}
        if self.cfg.aux_loss:
            out["aux_classes"] = classes[:-1].float()
            out["aux_coords"] = refs[:-1].float()
        return out

    def decode_static(self, memory, support_features):
        return self.decoder.precompute_static(memory, support_features,
                                              self.spatial_shapes)

    def decode_step(self, token_inputs, pos_index, mem_values, support_kvs,
                    support_mask, caches):
        return self.decoder.forward_step(
            token_inputs, pos_index, mem_values, self.spatial_shapes,
            support_kvs, support_mask, caches)


# ----------------------------------------------------------------------
@torch.inference_mode()
def autoregressive_decode(
    model: CAPE,
    images,
    support_coords,
    support_mask,
    skeleton_edges,
    force_length: Optional[int] = None,
    max_len: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Autoregressive generation on the model's device.

    The encoder runs once, then up to seq_len tokens are generated with
    static KV caches, stopping as soon as every sample has emitted EOS.
    Token-type branching is vectorized with `torch.where`, and predicted
    coordinates are re-tokenized (floor/ceil corner ids + deltas) on the
    device. Output buffers are (B, seq_len, ...); steps never executed stay
    at their defaults (zero logits/coords, valid=False).

    Inputs may be numpy arrays or tensors; they move to the model's device.

    Returns dict:
        pred_logits (B, L, 3) — per-step class-head logits (fp32)
        pred_coords (B, L, 2) — per-step coordinates (clipped to [0,1])
        gen_valid   (B, L) bool — True where a coordinate was generated
        lengths     (B,) int32 — generated tokens incl. EOS
        unfinished  (B,) bool — True if a sample hit max_len without EOS

    `max_len` caps generation below cfg.seq_len AND sizes the KV caches to
    it; outputs are padded back to (B, seq_len, ...). `force_length` makes
    every sample generate exactly that many tokens (a benchmark knob); it
    may exceed the cap, which then truncates with unfinished=True.
    """
    cfg = model.cfg
    dev = model.device
    tok = DiscreteTokenizer(num_bins=cfg.num_bins, seq_len=cfg.seq_len)
    images, support_coords, support_mask, skeleton_edges = (
        torch.as_tensor(x, device=dev) for x in
        (images, support_coords, support_mask, skeleton_edges))
    B = support_coords.shape[0]
    L = cfg.seq_len if max_len is None else min(int(max_len), cfg.seq_len)
    nb = cfg.num_bins

    memory = model.encode_image(images)
    support = model.encode_support(support_coords, support_mask,
                                   skeleton_edges)
    mem_values, support_kvs = model.decode_static(memory, support)
    caches = model.decoder.init_caches(B, L, dev)

    # initial token state: BOS with deltas (0, 0) (`roomformer_v2.py:362-383`)
    bos = torch.full((B, 1), tok.bos, dtype=torch.int64, device=dev)
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    state = {"seq11": bos, "seq12": bos, "seq21": bos, "seq22": bos,
             "delta_x1": zeros, "delta_y1": zeros,
             "delta_x2": zeros + 1.0, "delta_y2": zeros + 1.0}
    unfinished = torch.ones((B,), dtype=torch.bool, device=dev)
    logits_buf = torch.zeros((B, L, 3), dtype=torch.float32, device=dev)
    coords_buf = torch.zeros((B, L, 2), dtype=torch.float32, device=dev)
    valid_buf = torch.zeros((B, L), dtype=torch.bool, device=dev)
    active_buf = torch.zeros((B, L), dtype=torch.bool, device=dev)
    eos = torch.tensor(tok.eos, device=dev)
    sep = torch.tensor(tok.sep, device=dev)
    pad = torch.tensor(tok.pad, device=dev)

    for i in range(L):
        # the all-EOS early exit reads `unfinished` on the host: one device
        # sync per step (the JAX while_loop keeps it on the device)
        if not bool(unfinished.any()):
            break
        logits, ref, caches = model.decode_step(
            state, i, mem_values, support_kvs, support_mask, caches)
        logits = logits.float()[:, 0]                      # (B, 3)
        coords = ref.float()[:, 0]                         # (B, 2)
        cls = logits.argmax(dim=-1)                        # (B,)

        # token-type branching (`roomformer_v2.py:530-597`):
        # EOS before min_len is treated as a coordinate
        if force_length is not None:
            is_eos = torch.full((B,), i >= force_length - 1,
                                dtype=torch.bool, device=dev)
        else:
            is_eos = (cls == TokenType.eos) & (i >= cfg.min_decode_len)
        is_coord = (cls == TokenType.coord) | (
            (cls == TokenType.eos) & (i < cfg.min_decode_len))
        emit_coord = is_coord & unfinished

        xy = coords.clamp(0.0, 1.0)
        q = xy * (nb - 1)
        xf = torch.floor(q[:, 0]).to(torch.int64)
        yf = torch.floor(q[:, 1]).to(torch.int64)
        xc = torch.ceil(q[:, 0]).to(torch.int64)
        yc = torch.ceil(q[:, 1]).to(torch.int64)
        dx = q[:, 0] - torch.floor(q[:, 0])
        dy = q[:, 1] - torch.floor(q[:, 1])

        special = torch.where(is_eos, eos, sep)

        def pick(coord_id):
            """coord corner id if coord; sep/eos/pad specials otherwise."""
            live = torch.where(emit_coord, coord_id, special)
            return torch.where(unfinished, live, pad)[:, None]

        d_x = torch.where(emit_coord, dx, 0.0)[:, None]
        d_y = torch.where(emit_coord, dy, 0.0)[:, None]
        state = {"seq11": pick(xf * nb + yf), "seq12": pick(xf * nb + yc),
                 "seq21": pick(xc * nb + yf), "seq22": pick(xc * nb + yc),
                 "delta_x1": d_x, "delta_y1": d_y,
                 "delta_x2": 1.0 - d_x, "delta_y2": 1.0 - d_y}

        logits_buf[:, i] = logits
        coords_buf[:, i] = xy
        valid_buf[:, i] = emit_coord
        active_buf[:, i] = unfinished
        unfinished = unfinished & ~is_eos

    lengths = active_buf.sum(dim=1).to(torch.int32)
    out = {"pred_logits": logits_buf, "pred_coords": coords_buf,
           "gen_valid": valid_buf}
    if L < cfg.seq_len:  # restore the (B, seq_len, ...) caller contract
        out = {k: torch.nn.functional.pad(
            v, (0, 0, 0, cfg.seq_len - L) if v.dim() == 3
            else (0, cfg.seq_len - L)) for k, v in out.items()}
    out["lengths"] = lengths
    out["unfinished"] = unfinished
    return out

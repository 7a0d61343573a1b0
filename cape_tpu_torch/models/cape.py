"""CAPE model: backbone -> deformable encoder -> support-conditioned causal
decoder, plus the autoregressive decode loop: the port of
`cape_tpu.models.cape`.

- The backbone is the one `cfg.backbone` names (`BACKBONES`): ResNet-50
  (`models.backbone`), DINO-4scale's Swin-L (`models.swin`) or ViTDet-L
  (`models.vitdet`), each with a test copy; the input projections take
  its channels.
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
- Every config the JAX package builds, builds here: the decoder layer
  variants v2-v6 and `dec_attn_concat_src` (teacher-forced only: their
  decode raises the JAX package's `ValueError`), `dec_qkv_proj=False`,
  and the legacy `SupportPoseGraphEncoder` (`use_geometric_encoder=
  False`).
- `autoregressive_decode` generates up to `seq_len` tokens with static KV
  caches and on-device re-tokenization and token-type branching, exiting
  once every sample has emitted EOS. The JAX `while_loop` becomes a
  prologue (`decode_prologue`) and a token body (`decode_token`) that
  carries the position on the device and masks its writes, so that the
  body can be captured into a CUDA graph and replayed once a token
  (`graphs.decode`); the host reads the exit after every token but the
  last.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import trace
from ..config import CAPEConfig
from ..data.mp100 import IMAGENET_MEAN, IMAGENET_STD
from ..data.token_types import TokenType
from ..data.tokenizer import DiscreteTokenizer
from ..device import DeviceLike, resolve_device
from .backbone import ResNet50
from .decoder import Decoder
from .deformable import DeformableEncoder
from .layers import default_init_, normal_, uniform_, xavier_uniform_, zeros_
from .position_encoding import image_sine_pe_2d
from .support_encoder import GeometricSupportEncoder, SupportPoseGraphEncoder
from .swin import SWIN, SwinTransformer
from .vitdet import VITDET, ViTDet


def level_shapes(image_size: int, num_levels: int,
                 dilation: bool = False) -> Tuple[Tuple[int, int], ...]:
    """Static feature-map shapes: strides 8/16/32 (+64 for the extra level
    projected from layer4). DC5 dilation keeps layer4 at stride 16, so the
    strides become 8/16/16 (+32)."""
    strides = [8, 16, 16, 32] if dilation else [8, 16, 32, 64]
    return tuple((image_size // s, image_size // s)
                 for s in strides[:num_levels])


#: the backbones `cfg.backbone` names: ResNet-50 and its one-block test
#: copy (`models.backbone`), DINO's Swin-L and its test copy (`models.swin`),
#: ViTDet-L and its test copy (`models.vitdet`)
BACKBONES = ("resnet50", "resnet_tiny") + tuple(SWIN) + tuple(VITDET)


def build_backbone(cfg: CAPEConfig) -> nn.Module:
    """The backbone `cfg.backbone` names (its `channels` those of the
    stride-8/16/32 maps it returns); another name raises."""
    if cfg.backbone in SWIN or cfg.backbone in VITDET:
        if cfg.dilation:
            raise ValueError(f"backbone={cfg.backbone!r}: DC5 dilation is "
                             "ResNet-50's only")
        make = ViTDet if cfg.backbone in VITDET else SwinTransformer
        return make(cfg.backbone, cfg.input_channels)
    if cfg.backbone in ("resnet50", "resnet_tiny"):
        blocks = (1, 1, 1, 1) if cfg.backbone == "resnet_tiny" \
            else (3, 4, 6, 3)
        return ResNet50(cfg.input_channels, blocks, cfg.dilation)
    raise ValueError(f"backbone={cfg.backbone!r}: one of {BACKBONES}")


def _unsupported(cfg: CAPEConfig) -> Optional[str]:
    """The config options the JAX package itself refuses to build."""
    if cfg.support_fusion_method != "cross_attention":
        return (f"support_fusion_method={cfg.support_fusion_method!r}: only "
                "'cross_attention' is functional (matches the reference)")
    if cfg.position_embedding not in ("sine", "v2", "learned", "v3"):
        return (f"position_embedding={cfg.position_embedding!r}: 'sine'/'v2' "
                "or 'learned'/'v3' (reference position_encoding.py:76-81)")
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
        self.backbone = build_backbone(cfg)
        chans = self.backbone.channels
        d = cfg.hidden_dim
        # 1x1 conv + GroupNorm(32) per backbone level; extra stride-2 3x3
        # level from the last (`roomformer_v2.py:186-214`)
        self.input_projs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, d, 1), nn.GroupNorm(32, d, eps=1e-5))
             for c in chans]
            + [nn.Sequential(nn.Conv2d(chans[-1], d, 3, stride=2, padding=1),
                             nn.GroupNorm(32, d, eps=1e-5))])
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d))
        if self.learned_pe:
            # PositionEmbeddingLearned (`position_encoding.py:41-64`):
            # per-axis tables, pe = concat(col[x], row[y]), sized to the
            # largest feature level (the JAX package's choice)
            max_hw = max(h for h, _ in level_shapes(
                cfg.image_size, cfg.num_feature_levels, cfg.dilation))
            self.row_embed = nn.Parameter(torch.zeros(max_hw, d // 2))
            self.col_embed = nn.Parameter(torch.zeros(max_hw, d // 2))
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
            use_pallas=cfg.use_pallas_msda, layer_type=cfg.dec_layer_type,
            attn_concat_src=cfg.dec_attn_concat_src,
            qkv_proj=cfg.dec_qkv_proj, query_pos_type=cfg.query_pos_type,
            poly_refine=cfg.with_poly_refine)
        if cfg.use_geometric_encoder:
            self.support_encoder = GeometricSupportEncoder(
                d, cfg.support_encoder_layers, cfg.nheads,
                cfg.dim_feedforward, dropout=cfg.dropout,
                use_gcn=cfg.use_gcn_preenc, num_gcn_layers=cfg.num_gcn_layers,
                max_seq_pe=max(cfg.max_support_keypoints, 100))
        else:
            # the legacy encoder path (`cape_model.py:44-51`)
            self.support_encoder = SupportPoseGraphEncoder(
                d, cfg.support_encoder_layers, cfg.nheads,
                cfg.dim_feedforward, dropout=cfg.dropout)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        default_init_(self, generator)
        self.to(device)
        self._cast(torch.bfloat16 if cfg.bf16 else torch.float32)
        self._pe_cache: Dict[Tuple, torch.Tensor] = {}
        self._norm_cache: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self.eval()

    def init_weights(self, g: torch.Generator) -> None:
        for proj in self.input_projs:
            xavier_uniform_(proj[0].weight, g)
            zeros_(proj[0].bias)
        normal_(self.level_embed, 1.0, g)
        if self.learned_pe:
            uniform_(self.row_embed, g)
            uniform_(self.col_embed, g)

    def _cast(self, dtype: torch.dtype) -> None:
        """Cast to the compute dtype, keeping the fp32 islands in fp32: every
        sampling-offset projection (MSDA's, and v4's prefix sampler's) and
        the decoder's anchors."""
        self.to(dtype)
        for m in self.modules():
            offsets = getattr(m, "sampling_offsets", None)
            if isinstance(offsets, nn.Module):
                offsets.float()
        self.decoder.query_embed.data = self.decoder.query_embed.data.float()

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.level_embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.level_embed.dtype

    @property
    def learned_pe(self) -> bool:
        return self.cfg.position_embedding in ("learned", "v3")

    @property
    def spatial_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return level_shapes(self.cfg.image_size, self.cfg.num_feature_levels,
                            self.cfg.dilation)

    def _level_pe(self, h: int, w: int) -> torch.Tensor:
        """(h*w, D) positional encoding of one level: the learned tables'
        (col[x], row[y]), or the sine encoding, cached (made outside
        inference mode, so that a model decoded first still trains)."""
        if self.learned_pe:
            x_emb = self.col_embed[:w]                          # (w, D/2)
            y_emb = self.row_embed[:h]                          # (h, D/2)
            return torch.cat([x_emb[None].expand(h, w, -1),
                              y_emb[:, None].expand(h, w, -1)],
                             dim=-1).reshape(h * w, -1)
        key = (h, w, self.dtype, self.device)
        pe = self._pe_cache.get(key)
        if pe is None:
            with torch.inference_mode(False):
                pe = torch.as_tensor(image_sine_pe_2d(
                    h, w, self.cfg.hidden_dim).reshape(h * w, -1),
                    device=self.device).to(self.dtype)
            self._pe_cache[key] = pe
        return pe

    def _imagenet_stats(self, device) -> Tuple[torch.Tensor, ...]:
        """The ImageNet mean and std as fp32 tensors on `device`, made once
        (a copy from host memory cannot run while a CUDA graph captures)."""
        stats = self._norm_cache.get(device)
        if stats is None:
            with torch.inference_mode(False):
                stats = tuple(torch.as_tensor(v, dtype=torch.float32,
                                              device=device)
                              for v in (IMAGENET_MEAN, IMAGENET_STD))
            self._norm_cache[device] = stats
        return stats

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
                mean, std = self._imagenet_stats(images.device)
                images = (images - mean) / std
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        with self._backbone_span(x.device):
            feats = self.backbone(x)
        srcs = [self.input_projs[i](feats[i]) for i in range(3)]
        if self.cfg.num_feature_levels > 3:
            srcs.append(self.input_projs[3](feats[-1]))
        return self.encode_features(srcs, generator)

    @staticmethod
    def _backbone_span(device):
        """The `backbone` device span, where tracing is on and the stream
        is not being captured into a CUDA graph (a device span cannot be
        recorded there)."""
        if not trace.enabled() or (device.type == "cuda" and
                                   torch.cuda.is_current_stream_capturing()):
            return contextlib.nullcontext()
        return trace.device_span("backbone", device)

    def encode_features(self, srcs,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Post-projection NCHW levels (B, D, Hl, Wl) -> encoder memory.

        Each level flattens row-major to (B, Hl*Wl, D), the JAX package's
        order, and gets its positional encoding plus `level_embed`.
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
def decode_prologue(model: CAPE, images, support_coords, support_mask,
                    skeleton_edges, length: int) -> Dict:
    """Everything of a decode before its first token: the image and the
    support encoded, the decode-time constants (`decode_static`), KV caches
    of `length` slots, the BOS token state, the device position (a 0-d
    int64, the JAX `while_loop`'s `i`) and the (B, length, ...) output
    buffers. Returns the decode's carry: a dict of device tensors that
    `decode_token` advances in place, so that a captured CUDA graph finds
    them at the same addresses on every replay."""
    cfg = model.cfg
    dev = model.device
    tok = DiscreteTokenizer(num_bins=cfg.num_bins, seq_len=cfg.seq_len)
    B = support_coords.shape[0]
    memory = model.encode_image(images)
    support = model.encode_support(support_coords, support_mask,
                                   skeleton_edges)
    mem_values, support_kvs = model.decode_static(memory, support)
    # initial token state: BOS with deltas (0, 0) (`roomformer_v2.py:362-383`)
    bos = torch.full((B, 1), tok.bos, dtype=torch.int64, device=dev)
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    return {
        "mem_values": mem_values, "support_kvs": support_kvs,
        "support_mask": support_mask,
        "caches": model.decoder.init_caches(B, length, dev),
        "tokens": {"seq11": bos, "seq12": bos.clone(), "seq21": bos.clone(),
                   "seq22": bos.clone(), "delta_x1": zeros,
                   "delta_y1": zeros.clone(), "delta_x2": zeros + 1.0,
                   "delta_y2": zeros + 1.0},
        "pos": torch.zeros((), dtype=torch.int64, device=dev),
        "unfinished": torch.ones((B,), dtype=torch.bool, device=dev),
        "logits": torch.zeros((B, length, 3), dtype=torch.float32,
                              device=dev),
        "coords": torch.zeros((B, length, 2), dtype=torch.float32,
                              device=dev),
        "valid": torch.zeros((B, length), dtype=torch.bool, device=dev),
        "active": torch.zeros((B, length), dtype=torch.bool, device=dev),
    }


def decode_pending(carry: Dict) -> torch.Tensor:
    """0-d bool on the device: whether the next token would run, i.e. some
    sample is unfinished and the position is below the cap (the JAX
    `while_loop`'s condition)."""
    return carry["unfinished"].any() & (carry["pos"] < carry["logits"].shape[1])


def decode_token(model: CAPE, carry: Dict, force_length=None) -> None:
    """One token of the decode, in place on `carry` (`decode_prologue`),
    with no host read: every write is masked by `decode_pending`, so a
    token run after every sample has finished, or at the cap, changes
    nothing that the outputs read. Any number of calls past the end
    therefore returns what a loop that stopped exactly returns, the JAX
    `while_loop`'s result. `force_length` is an int or a 0-d int64 tensor
    on the device."""
    cfg = model.cfg
    nb = cfg.num_bins
    tok = DiscreteTokenizer(num_bins=nb, seq_len=cfg.seq_len)
    go = decode_pending(carry)
    L = carry["logits"].shape[1]
    pos = carry["pos"].clamp(max=L - 1)     # in range past the cap too
    at = pos.reshape(1)
    unfinished = carry["unfinished"]
    logits, ref, _ = model.decode_step(
        carry["tokens"], pos, carry["mem_values"], carry["support_kvs"],
        carry["support_mask"], carry["caches"])
    logits = logits.float()[:, 0]                      # (B, 3)
    coords = ref.float()[:, 0]                         # (B, 2)
    cls = logits.argmax(dim=-1)                        # (B,)

    # token-type branching (`roomformer_v2.py:530-597`):
    # EOS before min_len is treated as a coordinate
    if force_length is not None:
        is_eos = (pos >= force_length - 1).expand(cls.shape)
    else:
        is_eos = (cls == TokenType.eos) & (pos >= cfg.min_decode_len)
    is_coord = (cls == TokenType.coord) | (
        (cls == TokenType.eos) & (pos < cfg.min_decode_len))
    emit_coord = is_coord & unfinished

    xy = coords.clamp(0.0, 1.0)
    q = xy * (nb - 1)
    xf = torch.floor(q[:, 0]).to(torch.int64)
    yf = torch.floor(q[:, 1]).to(torch.int64)
    xc = torch.ceil(q[:, 0]).to(torch.int64)
    yc = torch.ceil(q[:, 1]).to(torch.int64)
    dx = q[:, 0] - torch.floor(q[:, 0])
    dy = q[:, 1] - torch.floor(q[:, 1])

    special = torch.where(is_eos, tok.eos, tok.sep)

    def pick(coord_id):
        """coord corner id if coord; sep/eos/pad specials otherwise."""
        live = torch.where(emit_coord, coord_id, special)
        return torch.where(unfinished, live, tok.pad)[:, None]

    d_x = torch.where(emit_coord, dx, 0.0)[:, None]
    d_y = torch.where(emit_coord, dy, 0.0)[:, None]
    new = {"seq11": pick(xf * nb + yf), "seq12": pick(xf * nb + yc),
           "seq21": pick(xc * nb + yf), "seq22": pick(xc * nb + yc),
           "delta_x1": d_x, "delta_y1": d_y,
           "delta_x2": 1.0 - d_x, "delta_y2": 1.0 - d_y}
    for k, v in new.items():   # read only by the next token, which is
        carry["tokens"][k].copy_(v)   # masked as this one is
    for k, row in (("logits", logits), ("coords", xy),
                   ("valid", emit_coord), ("active", unfinished)):
        buf = carry[k]
        kept = buf.index_select(1, at)[:, 0]
        buf.index_copy_(1, at, torch.where(go, row, kept)[:, None])
    unfinished.copy_(unfinished & ~(is_eos & go))
    carry["pos"].add_(go.long())


def decode_outputs(carry: Dict, seq_len: int) -> Dict[str, torch.Tensor]:
    """The decode's result from its carry, in new tensors (a captured
    graph's buffers are overwritten by its next replay): the (B, seq_len,
    ...) buffers, padded past a cap, `lengths` and `unfinished`."""
    L = carry["logits"].shape[1]
    out = {"pred_logits": carry["logits"], "pred_coords": carry["coords"],
           "gen_valid": carry["valid"]}
    # restore the (B, seq_len, ...) caller contract
    out = {k: torch.nn.functional.pad(
        v, (0, 0, 0, seq_len - L) if v.dim() == 3 else (0, seq_len - L))
        for k, v in out.items()}
    out["lengths"] = carry["active"].sum(dim=1).to(torch.int32)
    out["unfinished"] = carry["unfinished"].clone()
    return out


def decode_tokens(length: int, token: Callable[[], torch.Tensor],
                  device: torch.device) -> None:
    """The token loop of both decode routes: `token()` (one token body,
    returning `decode_pending`) once a token, and a host read of what it
    returned after every token but the last, until no sample is pending.
    A body is the span `decode.chunk` (timed on the device) and counts one
    `decode.steps`; a read is the span `decode.host_read` and counts one
    `decode.host_reads`."""
    for pos in range(length):
        with trace.device_span("decode.chunk", device):
            pending = token()
        trace.count("decode.steps")
        if pos == length - 1:
            return
        trace.count("decode.host_reads")
        with trace.span("decode.host_read"):
            if not bool(pending):
                return


def decode_length(cfg: CAPEConfig, max_len: Optional[int]) -> int:
    """The decode's token cap and KV-cache length."""
    return cfg.seq_len if max_len is None else min(int(max_len), cfg.seq_len)


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
    """Autoregressive generation on the model's device, eagerly.

    The encoder runs once (`decode_prologue`), then up to seq_len tokens
    are generated with static KV caches (`decode_token`), with a host read
    of `decode_pending` after every token but the last: the loop stops
    once every sample has emitted EOS. Token-type branching is vectorized
    with `torch.where`, and predicted coordinates are re-tokenized
    (floor/ceil corner ids + deltas) on the device. Output buffers are
    (B, seq_len, ...); steps never executed stay at their defaults (zero
    logits/coords, valid=False). `eval.evaluate.decode` replays the same
    bodies as captured CUDA graphs on the card (`graphs.decode`), and this
    records its spans and counters (`trace`) under the same names.

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
    dev = model.device
    with trace.span("decode"):
        with trace.device_span("decode.inputs", dev):
            images, support_coords, support_mask, skeleton_edges = (
                torch.as_tensor(x, device=dev) for x in
                (images, support_coords, support_mask, skeleton_edges))
        L = decode_length(model.cfg, max_len)
        with trace.device_span("decode.prologue", dev):
            carry = decode_prologue(model, images, support_coords,
                                    support_mask, skeleton_edges, L)

        def token():
            decode_token(model, carry, force_length)
            return decode_pending(carry)

        decode_tokens(L, token, dev)
        with trace.device_span("decode.outputs", dev):
            return decode_outputs(carry, model.cfg.seq_len)

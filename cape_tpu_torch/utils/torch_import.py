"""Import reference (PyTorch) CAPE checkpoints into the port: the port of
`cape_tpu.utils.torch_import`, mapped straight onto the port's modules.

The reference trains `CAPEModel(base_model=RoomFormerV2)` and saves
`{'model': state_dict, 'args': Namespace, 'epoch', 'best_pck'}`. This
module maps every live tensor of that state dict onto the port's
`CAPE.state_dict()`:

    base_model.backbone.0.body.*      -> backbone (BN folded to FrozenAffine)
    base_model.input_proj.{i}.{0,1}.* -> input_projs.i.{0,1} (conv, GroupNorm)
    base_model.transformer.*          -> level_embed / encoder / decoder
                                         (nn.MultiheadAttention's in_proj
                                         split into q/k/v projections)
    base_model.{class,coords}_embed.* -> decoder.class_heads / coords_heads
    base_model.query_embed.weight     -> decoder.query_embed
    support_encoder.*                 -> the geometric support encoder
                                         (GCN Conv1d -> Linear), or the
                                         legacy SupportPoseGraphEncoder
                                         when the checkpoint was trained
                                         with --use_geometric_encoder off

and drops, as the JAX package does, the reference's trained-but-unused
tensors (`support_cross_attention_layers`, `support_attn_layer_norms`,
`support_proj`). Torch Linear and Conv2d layouts are the port's own, so
besides the splits, the Conv1d squeeze and the BN folding every tensor is
copied as it is. The errors are the JAX package's `CheckpointImportError`
messages: a missing key names it, a shape mismatch names the tensor, a
non-v1 decoder and a legacy/geometric mismatch are refused.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import CAPEConfig


class CheckpointImportError(ValueError):
    """A reference key is missing or shaped wrong for the target config."""


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def config_from_reference_args(args: Dict[str, Any], **overrides) -> CAPEConfig:
    """Build a CAPEConfig from the reference's pickled `args` Namespace
    (passed as a plain dict). Only architecture-relevant fields transfer;
    anything absent keeps the default; kwargs win over both."""
    field_map = [
        "hidden_dim", "nheads", "enc_layers", "dec_layers",
        "dim_feedforward", "dropout", "num_feature_levels",
        "dec_n_points", "enc_n_points", "seq_len", "vocab_size",
        "image_size", "num_gcn_layers", "use_gcn_preenc",
        "support_encoder_layers", "aux_loss", "lr", "lr_backbone",
        "label_smoothing", "eos_weight",
    ]
    kw = {f: args[f] for f in field_map
          if f in args and args[f] is not None}
    if args.get("dec_layer_type"):
        kw["dec_layer_type"] = args["dec_layer_type"]
    kw.update(overrides)
    return CAPEConfig(**kw)


class _Mapper:
    """Collects port tensors (fp32, CPU) from reference keys."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = sd
        self.out: Dict[str, np.ndarray] = {}

    def get(self, key: str) -> np.ndarray:
        return _array(self.sd[key])            # KeyError names the key

    def linear(self, dst: str, src: str) -> None:
        self.out[f"{dst}.weight"] = self.get(f"{src}.weight")
        if f"{src}.bias" in self.sd:
            self.out[f"{dst}.bias"] = self.get(f"{src}.bias")

    def norm(self, dst: str, src: str) -> None:
        self.out[f"{dst}.weight"] = self.get(f"{src}.weight")
        self.out[f"{dst}.bias"] = self.get(f"{src}.bias")

    def mha(self, dst: str, src: str, d: int) -> None:
        """torch.nn.MultiheadAttention -> the port's MultiHeadAttention."""
        w, b = self.get(f"{src}.in_proj_weight"), self.get(f"{src}.in_proj_bias")
        for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
            self.out[f"{dst}.{name}.weight"] = w[i * d:(i + 1) * d]
            self.out[f"{dst}.{name}.bias"] = b[i * d:(i + 1) * d]
        self.linear(f"{dst}.out_proj", f"{src}.out_proj")

    def msda(self, dst: str, src: str) -> None:
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            self.linear(f"{dst}.{name}", f"{src}.{name}")


def _map_tensors(m: _Mapper, cfg: CAPEConfig, model) -> None:
    """Every mapped tensor into `m.out`, in the JAX package's order (so the
    first missing key is the one it reports)."""
    from ..models.backbone import resnet50_state_from_torchvision

    sd, tr, D = m.sd, "base_model.transformer", cfg.hidden_dim
    # ---- backbone (BN stats folded into frozen affines) ---------------
    prefix = "base_model.backbone.0.body."
    bsd = {k[len(prefix):]: _array(v) for k, v in sd.items()
           if k.startswith(prefix)}
    if bsd:
        for name, value in resnet50_state_from_torchvision(
                model.backbone, bsd).items():
            m.out[f"backbone.{name}"] = value.numpy()

    # ---- input projections ----------------------------------------------
    for i in range(cfg.num_feature_levels):
        m.linear(f"input_projs.{i}.0", f"base_model.input_proj.{i}.0")
        m.norm(f"input_projs.{i}.1", f"base_model.input_proj.{i}.1")

    # ---- encoder ----------------------------------------------------------
    m.out["level_embed"] = m.get(f"{tr}.level_embed")
    for i in range(cfg.enc_layers):
        el, pl = f"{tr}.encoder.layers.{i}", f"encoder.layers.{i}"
        m.msda(f"{pl}.self_attn", f"{el}.self_attn")
        m.norm(f"{pl}.norm1", f"{el}.norm1")
        m.linear(f"{pl}.linear1", f"{el}.linear1")
        m.linear(f"{pl}.linear2", f"{el}.linear2")
        m.norm(f"{pl}.norm2", f"{el}.norm2")

    # ---- decoder ----------------------------------------------------------
    dec = f"{tr}.decoder"
    m.out["decoder.token_embed.weight"] = m.get(f"{dec}.token_embed.weight")
    m.out["decoder.query_embed"] = m.get("base_model.query_embed.weight")
    m.linear("decoder.pos_trans", f"{dec}.pos_trans")
    m.norm("decoder.pos_trans_norm", f"{dec}.pos_trans_norm")
    for i in range(cfg.dec_layers):
        dl, pl = f"{dec}.layers.{i}", f"decoder.layers.{i}"
        for name in ("attn_q", "attn_k", "attn_v"):
            m.linear(f"{pl}.{name}", f"{dl}.{name}")
        m.mha(f"{pl}.self_attn", f"{dl}.self_attn", D)
        m.norm(f"{pl}.norm2", f"{dl}.norm2")
        m.mha(f"{pl}.support_attn", f"{dl}.support_attn", D)
        m.norm(f"{pl}.norm_support", f"{dl}.norm_support")
        m.msda(f"{pl}.cross_attn", f"{dl}.cross_attn")
        m.norm(f"{pl}.norm1", f"{dl}.norm1")
        m.linear(f"{pl}.linear1", f"{dl}.linear1")
        m.linear(f"{pl}.linear2", f"{dl}.linear2")
        m.norm(f"{pl}.norm3", f"{dl}.norm3")
        # per-layer heads: stored twice in the reference state dict
        # (base_model.class_embed.N and transformer.decoder.class_embed.N
        # alias the same tensors); read the base_model copy
        m.linear(f"decoder.class_heads.{i}", f"base_model.class_embed.{i}")
        for j in range(3):
            m.linear(f"decoder.coords_heads.{i}.layers.{j}",
                     f"base_model.coords_embed.{i}.layers.{j}")

    # ---- support encoder (geometric default / legacy graph) -------------
    legacy = "support_encoder.coord_embedding.0.weight" in sd
    if legacy != (not cfg.use_geometric_encoder):
        want = "false" if legacy else "true"
        kind = ("SupportPoseGraphEncoder" if legacy
                else "GeometricSupportEncoder")
        raise CheckpointImportError(
            f"checkpoint carries a {kind} but config has "
            f"use_geometric_encoder={cfg.use_geometric_encoder} — pass "
            f"--set use_geometric_encoder={want}")
    se = "support_encoder"
    if legacy:
        m.linear(f"{se}.coord_mlp_0", f"{se}.coord_embedding.0")
        m.linear(f"{se}.coord_mlp_1", f"{se}.coord_embedding.2")
        m.out[f"{se}.edge_embedding.weight"] = m.get(
            f"{se}.edge_embedding.weight")
        m.linear(f"{se}.coord_edge_proj", f"{se}.coord_edge_proj")
        m.norm(f"{se}.final_norm", f"{se}.norm")
    else:
        m.linear(f"{se}.coord_mlp_0", f"{se}.coord_mlp.0")
        m.linear(f"{se}.coord_mlp_1", f"{se}.coord_mlp.2")
        if cfg.use_gcn_preenc:
            for i in range(cfg.num_gcn_layers):
                # GCNLayer's Conv1d(in, out*k, 1) -> Linear(in, out*k)
                src = f"{se}.gcn_layers.{i}.conv"
                m.out[f"{se}.gcn.{i}.linear.weight"] = m.get(
                    f"{src}.weight")[:, :, 0]
                m.out[f"{se}.gcn.{i}.linear.bias"] = m.get(f"{src}.bias")
    for i in range(cfg.support_encoder_layers):
        sl = f"{se}.transformer_encoder.layers.{i}"
        pl = f"{se}.layers.{i}"
        m.mha(f"{pl}.self_attn", f"{sl}.self_attn", D)
        m.norm(f"{pl}.norm1", f"{sl}.norm1")
        m.linear(f"{pl}.linear1", f"{sl}.linear1")
        m.linear(f"{pl}.linear2", f"{sl}.linear2")
        m.norm(f"{pl}.norm2", f"{sl}.norm2")


def import_reference_state_dict(
    sd: Mapping[str, Any],
    cfg: CAPEConfig,
    base: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Map a reference CAPEModel state dict (numpy arrays or tensors) onto
    the port's fp32 `state_dict` for `CAPE(cfg)`.

    Tensors the checkpoint does not carry (the backbone, when it has no
    `base_model.backbone.*` keys; the learned position tables) come from
    `base`, a state_dict of the same model, by default a fresh `CAPE(cfg)`
    from `cfg.seed`: the JAX package's `variables` argument.

    Raises CheckpointImportError with the offending key on any missing
    tensor, shape mismatch or tensor the model does not have.
    """
    from ..models.cape import CAPE

    if cfg.dec_layer_type != "v1":
        raise CheckpointImportError(
            f"dec_layer_type={cfg.dec_layer_type!r}: checkpoint import "
            "supports the CAPE-shipped v1 decoder layer (the reference's "
            "v2-v6 experiments are teacher-forced-only and were never the "
            "released protocol)")
    model = CAPE(cfg.replace(bf16=False), device="cpu")
    m = _Mapper(sd)
    try:
        _map_tensors(m, cfg, model)
    except KeyError as e:
        raise CheckpointImportError(
            f"reference checkpoint is missing key {e.args[0]!r} — wrong "
            "architecture args for this checkpoint?") from None

    expected = model.state_dict() if base is None else base
    out = {k: v.detach().float().cpu().clone() for k, v in expected.items()}
    for key, value in m.out.items():
        if key not in out:
            raise CheckpointImportError(
                f"checkpoint tensor for {key} has no place in the model — "
                "config does not match checkpoint")
        if tuple(value.shape) != tuple(out[key].shape):
            raise CheckpointImportError(
                f"shape mismatch at {key}: checkpoint {tuple(value.shape)} "
                f"vs model {tuple(out[key].shape)} — config does not match "
                "checkpoint")
        out[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out

"""Model modules of the port, exported as the JAX package's
`cape_tpu.models` exports them."""

from .cape import CAPE, autoregressive_decode, level_shapes
from .backbone import ResNet50, load_torch_resnet50_npz
from .decoder import Decoder, DecoderLayer, inverse_sigmoid
from .deformable import DeformableEncoder, MSDeformAttn
from .support_encoder import GeometricSupportEncoder, SupportPoseGraphEncoder
from .matcher import hungarian_match

__all__ = [
    "CAPE",
    "autoregressive_decode",
    "level_shapes",
    "ResNet50",
    "load_torch_resnet50_npz",
    "Decoder",
    "DecoderLayer",
    "inverse_sigmoid",
    "DeformableEncoder",
    "MSDeformAttn",
    "GeometricSupportEncoder",
    "SupportPoseGraphEncoder",
    "hungarian_match",
]

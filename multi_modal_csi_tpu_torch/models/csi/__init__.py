"""CSI models ported so far: the THAT family, THAT_ENCODER and DETR."""

from .detr import (CNNFeatureExtractor, DepthwiseSeparableConv,
                   DETRMultiUser, DilatedConvBlock, TransformerDecoder,
                   TransformerDecoderLayer, TransformerEncoder)
from .that import (THAT, EncoderBlock, GaussianPosition, THATCount,
                   THATCountConstrained, THATMultiHead, THATTrunk)
from .that_encoder import (THATEncoderDecoder, THATEncoderDETR,
                           THATEncoderMemory)

__all__ = [
    "CNNFeatureExtractor", "DepthwiseSeparableConv", "DETRMultiUser",
    "DilatedConvBlock", "EncoderBlock", "GaussianPosition", "THAT",
    "THATCount", "THATCountConstrained", "THATEncoderDecoder",
    "THATEncoderDETR", "THATEncoderMemory", "THATMultiHead", "THATTrunk",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
]

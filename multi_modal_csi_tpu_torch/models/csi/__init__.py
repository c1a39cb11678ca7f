"""CSI models ported so far: the THAT family and DETR."""

from .detr import (CNNFeatureExtractor, DepthwiseSeparableConv,
                   DETRMultiUser, DilatedConvBlock, TransformerDecoder,
                   TransformerDecoderLayer, TransformerEncoder)
from .that import (THAT, EncoderBlock, GaussianPosition, THATCount,
                   THATCountConstrained, THATMultiHead, THATTrunk)

__all__ = [
    "CNNFeatureExtractor", "DepthwiseSeparableConv", "DETRMultiUser",
    "DilatedConvBlock", "EncoderBlock", "GaussianPosition", "THAT",
    "THATCount", "THATCountConstrained", "THATMultiHead", "THATTrunk",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
]

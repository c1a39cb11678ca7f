"""CSI models ported so far: the WiMANS baselines (MLP, CNN-1D, CNN-2D,
LSTM, CLSTM, ABLSTM), the THAT family, THAT_ENCODER and DETR."""

from .ablstm import ABLSTM
from .clstm import CLSTM
from .cnn_1d import CNN1D
from .cnn_2d import CNN2D
from .detr import (CNNFeatureExtractor, DepthwiseSeparableConv,
                   DETRMultiUser, DilatedConvBlock, TransformerDecoder,
                   TransformerDecoderLayer, TransformerEncoder)
from .lstm import LSTMModel
from .mlp import MLP
from .that import (THAT, EncoderBlock, GaussianPosition, THATCount,
                   THATCountConstrained, THATMultiHead, THATTrunk)
from .that_encoder import (THATEncoderDecoder, THATEncoderDETR,
                           THATEncoderMemory)

__all__ = [
    "ABLSTM", "CLSTM", "CNN1D", "CNN2D", "CNNFeatureExtractor",
    "DepthwiseSeparableConv", "DETRMultiUser", "DilatedConvBlock",
    "EncoderBlock", "GaussianPosition", "LSTMModel", "MLP", "THAT",
    "THATCount", "THATCountConstrained", "THATEncoderDecoder",
    "THATEncoderDETR", "THATEncoderMemory", "THATMultiHead", "THATTrunk",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
]

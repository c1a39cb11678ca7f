"""The CSI models: the WiMANS baselines (MLP, CNN-1D, CNN-2D, LSTM,
CLSTM, ABLSTM), the THAT family, THAT_ENCODER, DETR, the self-supervised
SSLModel and DualBandCNN; ST-RF's features and forest are in ``strf``."""

from .ablstm import ABLSTM
from .clstm import CLSTM
from .cnn_1d import CNN1D
from .cnn_2d import CNN2D
from .dual_band import DualBandCNN
from .detr import (CNNFeatureExtractor, DepthwiseSeparableConv,
                   DETRMultiUser, DilatedConvBlock, TransformerDecoder,
                   TransformerDecoderLayer, TransformerEncoder)
from .lstm import LSTMModel
from .mlp import MLP
from .ssl import SSLModel, info_nce, ssl_loss, two_views
from .that import (THAT, EncoderBlock, GaussianPosition, THATCount,
                   THATCountConstrained, THATMultiHead, THATTrunk)
from .that_encoder import (THATEncoderDecoder, THATEncoderDETR,
                           THATEncoderMemory)

__all__ = [
    "ABLSTM", "CLSTM", "CNN1D", "CNN2D", "CNNFeatureExtractor",
    "DepthwiseSeparableConv", "DETRMultiUser", "DilatedConvBlock",
    "DualBandCNN", "EncoderBlock", "GaussianPosition", "LSTMModel", "MLP",
    "SSLModel", "THAT",
    "THATCount", "THATCountConstrained", "THATEncoderDecoder",
    "THATEncoderDETR", "THATEncoderMemory", "THATMultiHead", "THATTrunk",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
    "info_nce", "ssl_loss", "two_views",
]

"""The video backbones of the JAX package's ``models/video``: MViT-v1
(``mvit_v1_b``), MViT-v2 (``mvit_v2_s``), ResNet3D-18, S3D, Swin3D-T
(``swin3d_t``) and Swin3D-S (``swin3d_s``)."""

from .mvit import MViT, MViTBackbone, mvit_v1_b, mvit_v2_s
from .resnet3d import ResNet3D18, ResNet3DBackbone
from .s3d import S3D, S3DBackbone
from .swin3d import Swin3D, Swin3DBackbone, swin3d_s, swin3d_t

__all__ = ["MViT", "MViTBackbone", "mvit_v1_b", "mvit_v2_s", "ResNet3D18",
           "ResNet3DBackbone", "S3D", "S3DBackbone", "Swin3D",
           "Swin3DBackbone", "swin3d_s", "swin3d_t"]

"""Video models ported so far: MViT-v1 (``mvit_v1_b``) and MViT-v2
(``mvit_v2_s``). ResNet3D, S3D and Swin3D are still to port."""

from .mvit import MViT, MViTBackbone, mvit_v1_b, mvit_v2_s

__all__ = ["MViT", "MViTBackbone", "mvit_v1_b", "mvit_v2_s"]

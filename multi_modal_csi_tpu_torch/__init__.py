"""PyTorch + CUDA port of multi_modal_csi_tpu for NVIDIA Hopper (H100).

The JAX package ``multi_modal_csi_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version instead.
"""

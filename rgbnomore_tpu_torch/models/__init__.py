"""PyTorch models: the ViT with the grouped DCT patch embedding, and SwinV2
with the patch-4 DCT embedding."""

from rgbnomore_tpu_torch.models.swinv2 import SwinTransformerV2
from rgbnomore_tpu_torch.models.vit import ViT

"""PyTorch models: the ViT with the grouped DCT patch embedding."""

from rgbnomore_tpu_torch.models.vit import ViT

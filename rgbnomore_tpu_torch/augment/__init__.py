"""The device half of the input pipelines (DCT and RGB, every transfer),
the batched DCT and RGB RandAugment, and the pixel oracles."""

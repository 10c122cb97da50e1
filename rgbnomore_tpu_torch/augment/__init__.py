"""The device half of the input pipelines (cropped DCT wire, eval and train)
and the batched DCT RandAugment."""

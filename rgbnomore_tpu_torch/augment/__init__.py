"""The device half of the input pipeline (the cropped DCT eval path)."""

"""Evaluation entry points: the library's ``evaluate_model`` (the JAX
package's ``eval.py:17-22``), ``benchmark_model`` re-exported from
``benchmark.py`` (as the JAX ``eval.py:13`` does) and the eval CLI.

    python -m rgbnomore_tpu_torch.eval --loadpath models/vitti.pt --model_arch vitti ...

takes the train CLI's flags (``rgbnomore_tpu_torch/cli.py``) with
``--eval`` forced and ``--train`` dropped, as the JAX ``eval.py:25-35``
does, so it can never start a training run.
"""

from __future__ import annotations

import sys

from rgbnomore_tpu_torch.benchmark import benchmark_model
from rgbnomore_tpu_torch.train.config import Config
from rgbnomore_tpu_torch.train.loop import train_and_eval

__all__ = ["benchmark_model", "evaluate_model"]


def evaluate_model(cfg: Config, index_train: str, index_val: str, loadpath: str = "",
                   **kw) -> dict:
    """Evaluate the config's model (the ViT or SwinV2) on the test
    (``index_val``), minival and trainval splits over the cropped wire of
    its domain (``make_loaders``): for DCT the K=48 mask16 rows of the
    center crop for the ViT, of the whole-image resize for SwinV2; for RGB
    the K=63 mask16 rows of the Resize + CenterCrop box's window (ViT) or of
    the whole image (SwinV2), decoded to pixels on the device.  The model computes in the
    config's AMP dtype (``amp_compute_dtype``): the ``vitb``, ``vitl`` and
    ``swinv2`` presets in bf16, the others in float32; logits are float32.

    ``loadpath`` names a ``state_dict`` saved with ``torch.save`` (see
    ``convert.py`` for weights trained by the JAX package); without it the
    weights are drawn from ``cfg.seed``.  ``kw`` goes to ``train_and_eval``
    (``device``, default ``cuda``; ``num_threads``; the wire's K and
    formats).  Returns ``{"test": ..., "val": ..., "trainval": ...}``, each
    ``{"accuracy", "loss", "count"}``.
    """
    if not loadpath:
        kw.setdefault("savepath", "")  # no weights file: the seed's weights
    return train_and_eval(cfg, index_train, index_val, loadpath=loadpath, run_train=False,
                          run_eval=True, **kw)


def main(argv: list[str] | None = None) -> dict:
    """The eval CLI: ``cli.main`` with ``--eval`` forced and ``--train``
    dropped."""
    from rgbnomore_tpu_torch import cli

    argv = [a for a in (sys.argv[1:] if argv is None else argv) if a != "--train"]
    if "--eval" not in argv:
        argv.insert(0, "--eval")
    return cli.main(argv)


if __name__ == "__main__":
    import json

    print(json.dumps(main()))

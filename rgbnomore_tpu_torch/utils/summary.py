"""Startup model summary, the port's counterpart of the JAX package's
``utils/summary.py``.

The reference prints a ``torchinfo.summary`` of the model on its declared
input shapes at startup (``utils/pipeline_utils.py:383-384``), which catches
shape breaks before the first real batch; the JAX package prints flax's
``Module.tabulate``.  Here one forward pass on the config's zero inputs
(``train/config.py:example_inputs``) runs on the CPU under forward hooks and
gives a table of the modules down to ``depth``: path, type, output and
parameters, totalled at the end as flax totals them.
"""

from __future__ import annotations

import torch

__all__ = ["model_summary"]


def _describe(out) -> str:
    """``float32[2,1000]`` for a tensor; the tensors of a tuple or list
    joined by spaces; ``-`` for anything else."""
    if isinstance(out, torch.Tensor):
        return f"{str(out.dtype).removeprefix('torch.')}[{','.join(map(str, out.shape))}]"
    if isinstance(out, (tuple, list)):
        return " ".join(_describe(o) for o in out) or "-"
    return "-"


def _count(params) -> int:
    return sum(p.numel() for p in params)


def model_summary(model: torch.nn.Module, cfg, batch: int = 2, depth: int = 2) -> str:
    """The per-module table of ``model`` on ``cfg``'s declared input shapes
    at ``batch``, down to ``depth`` levels below the model.  A row's
    parameters are the module's own, or its whole subtree's where the table
    stops at it, so the column sums to the total.  The forward pass runs on
    the CPU without grad: a model on another device is summarised through a
    copy of it on the CPU (``utils/profiling.on_cpu``), so the summary
    runs nothing on the card."""
    from rgbnomore_tpu_torch.train.config import example_inputs
    from rgbnomore_tpu_torch.utils.profiling import on_cpu

    model = on_cpu(model)
    shown = {name: module for name, module in model.named_modules()
             if (name.count(".") + 1 if name else 0) <= depth}
    outputs: dict[str, str] = {}

    def hook(name):
        def record(module, args, out):
            outputs.setdefault(name, _describe(out))
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in shown.items()]
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(*example_inputs(cfg, batch=batch, device="cpu"))
    finally:
        model.train(training)
        for h in handles:
            h.remove()

    rows = [("path", "module", "outputs", "params")]
    for name, module in shown.items():
        at_depth = (name.count(".") + 1 if name else 0) == depth
        n = _count(module.parameters(recurse=at_depth))
        rows.append((name.replace(".", "/"), type(module).__name__, outputs.get(name, "-"),
                     f"{n:,}" if n else ""))
    params = list(model.parameters())
    total = _count(params)
    nbytes = sum(p.numel() * p.element_size() for p in params)
    rows.append(("", "", "Total", f"{total:,} ({nbytes / 1e6:.1f} MB)"))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    lines = [" | ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in rows]
    lines.insert(1, "-+-".join("-" * w for w in widths))
    lines.insert(-1, lines[1])
    lines.append(f"Total Parameters: {total:,} ({nbytes / 1e6:.1f} MB)")
    return f"{type(model).__name__} Summary\n" + "\n".join(lines)

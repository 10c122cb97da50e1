"""The port's spans and counters (``rgbnomore_tpu_torch/utils/profiling.py``)
on the CPU.

- With the profiler off a span opens no profiler event, and ``totals()``
  counts each span of a tiny ViT-Ti train step and eval batch once a step
  (the attention spans once a block).
- Under ``profiling.trace`` the same steps give the span tree: each child
  inside its parent, every span of a step inside that step's
  ``rgbnm.step``, which carries the step's index.
- ``rgbnm.upload.bytes`` is the rows' bytes a step.
- The loader's ``rgbnm.loader.decode`` on its producer thread carries the
  index of the batch that the matching ``rgbnm.loader.wait`` received.
- Threads that add to one counter or span lose no count.

Two gloo ranks' exchange spans and bytes are held in
``tests/test_torch_port_distributed.py``, on its two-rank run.
"""

import json
import threading

import numpy as np
import pytest
import torch

from torch_port_support import (
    port_spans,
    random_wire_rows,
    settle_inspect_module_walk,
    spans_per_step,
    torch_threads,
    write_corpus,
)
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.data.loader import DctCroppedLoader
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer
from rgbnomore_tpu_torch.utils import profiling

BATCH, GRID, DEPTH = 4, 8, 2
# a train step's spans below rgbnm.step on the CPU, and how often a step
# opens each (the policy's copy to the card, rgbnm.pipeline.policy, is the
# card's alone)
STEP_SPANS = {"rgbnm.draw": 1, "rgbnm.pipeline": 1, "rgbnm.mixup": 1, "rgbnm.forward": 1,
              "rgbnm.backward": 1, "rgbnm.optimizer": 1, "rgbnm.attn.fwd": DEPTH,
              "rgbnm.attn.bwd": DEPTH}
# child -> parent of the spans a train step nests
PARENTS = {"rgbnm.draw": "rgbnm.step", "rgbnm.pipeline": "rgbnm.step",
           "rgbnm.mixup": "rgbnm.step", "rgbnm.forward": "rgbnm.step",
           "rgbnm.backward": "rgbnm.step", "rgbnm.optimizer": "rgbnm.step",
           "rgbnm.attn.fwd": "rgbnm.forward", "rgbnm.attn.bwd": "rgbnm.backward"}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    settle_inspect_module_walk()  # the optimizer's first use imports torch._dynamo
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _trainer() -> Trainer:
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, epochs=1,
                          warmup_steps=1)
    cfg.model.depth, cfg.model.dct_blocks = DEPTH, GRID
    trainer = Trainer(cfg, device="cpu")
    trainer.create_state(steps_per_epoch=4)
    return trainer


def _rows(seed: int, k: int) -> dict:
    return {"packed": random_wire_rows(np.random.default_rng(seed), BATCH, GRID, k)}


def _calls(name: str) -> int:
    return profiling.totals()["spans"].get(name, {}).get("calls", 0)


def test_spans_count_once_a_step_with_the_profiler_off(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_enter_event", lambda *a: opened.append(a))
    trainer = _trainer()
    steps = 2
    for i in range(steps):
        trainer.train_step(trainer.upload(_rows(i, trainer.packed_k)))
    trainer.evaluate([_rows(9, trainer.packed_k_eval)])
    assert opened == []
    spans = profiling.totals()["spans"]
    assert all(name.startswith("rgbnm.") for name in spans)
    want = {name: n * steps for name, n in STEP_SPANS.items()}
    want.update({"rgbnm.step": steps, "rgbnm.upload": steps + 1, "rgbnm.eval": 1,
                 "rgbnm.eval_step": 1})
    for name in ("rgbnm.pipeline", "rgbnm.forward"):
        want[name] += 1  # the eval batch's
    want["rgbnm.attn.fwd"] += DEPTH
    assert {name: s["calls"] for name, s in spans.items()} == want
    assert all(s["host_s"] > 0 for s in spans.values())
    assert spans["rgbnm.step"]["host_s"] >= spans["rgbnm.forward"]["host_s"]


def _tree(tmp_path, block) -> list:
    """The port's spans in a ``profiling.trace`` of ``block()``."""
    with profiling.trace(str(tmp_path)):
        block()
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        return port_spans(json.load(f)["traceEvents"])


def test_span_tree_under_the_profiler(tmp_path):
    trainer = _trainer()
    trainer.train_step(trainer.upload(_rows(0, trainer.packed_k)))  # before the trace
    batches = [trainer.upload(_rows(i, trainer.packed_k)) for i in (1, 2)]

    def block():
        for packed in batches:
            trainer.train_step(packed)

    spans = _tree(tmp_path, block)
    steps, outside = spans_per_step(spans)
    assert outside == []
    assert [s["index"] for s in steps] == [1, 2]
    assert all(s["spans"] == STEP_SPANS for s in steps)
    for child in spans:
        parent = PARENTS.get(child["name"])
        if parent is None:
            continue
        assert any(p["name"] == parent and p["ts"] <= child["ts"] and child["end"] <= p["end"]
                   for p in spans), child


def test_upload_bytes_are_the_rows_bytes_a_step():
    trainer = _trainer()
    batches = [_rows(i, trainer.packed_k) for i in range(3)]
    for b in batches:
        trainer.train_step(trainer.upload(b))
    counters = profiling.totals()["counters"]
    assert counters["rgbnm.upload.bytes"] == sum(b["packed"].nbytes for b in batches)
    assert _calls("rgbnm.upload") == 3


def test_loader_decode_carries_the_waited_batch_index(tmp_path):
    (tmp_path / "corpus").mkdir()
    ds = load_index(write_corpus(tmp_path / "corpus", n=12))
    loader = DctCroppedLoader(ds, 4, target=GRID, k=16, mode="train", shuffle=True,
                              drop_last=True, seed=3, num_threads=2)
    got = []
    spans = _tree(tmp_path / "trace", lambda: got.extend(loader))
    assert len(got) == 3 == profiling.totals()["counters"]["rgbnm.loader.batches"]
    waits = [s for s in spans if s["name"] == "rgbnm.loader.wait"]
    decodes = {s["index"]: s for s in spans if s["name"] == "rgbnm.loader.decode"}
    assert sorted(decodes) == [0, 1, 2]
    assert [w["index"] for w in waits] == [0, 1, 2, 3]  # the last receives the end
    for w in waits[:3]:
        d = decodes[w["index"]]
        assert d["tid"] != w["tid"] and d["end"] <= w["end"]


def test_threads_lose_no_count():
    n, threads = 5000, 4

    def work():
        for _ in range(n):
            profiling.count("rgbnm.test.count", 3)
            with profiling.span("rgbnm.test.span"):
                pass

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    got = profiling.totals()
    assert got["counters"]["rgbnm.test.count"] == 3 * n * threads
    assert got["spans"]["rgbnm.test.span"]["calls"] == n * threads


def test_reset_clears_the_totals():
    with profiling.span("rgbnm.test.span", 7):
        profiling.count("rgbnm.test.count")
    assert _calls("rgbnm.test.span") == 1
    profiling.reset()
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_span_opens_an_event_only_while_recording(tmp_path):
    with profiling.span("rgbnm.test.off"):
        torch.ones(2).add_(1)

    def block():
        with profiling.span("rgbnm.test.on", 5):
            pass

    spans = _tree(tmp_path, block)
    assert [(s["name"], s["index"]) for s in spans] == [("rgbnm.test.on", 5)]
    assert _calls("rgbnm.test.off") == _calls("rgbnm.test.on") == 1

"""The port's benchmark harness on the CPU: ``utils/timing.py``,
``benchmark.py`` (the six FPS metrics) and the bench entry
(``python -m rgbnomore_tpu_torch.bench``).

- The timing functions order two workloads and thread a step's state, as
  ``tests/test_timing.py`` asserts for the JAX package's.
- ``benchmark_dataloader`` and ``benchmark_pipeline`` (train and test) on
  the tiny JPEG corpus the CLI tests build; ``benchmark_model_synthetic``
  forward at depth 1 runs 2 x 300 images (``tests/test_e2e.py:130-145``),
  fwd+bwd too; ``benchmark_model`` returns the JAX package's six keys, and
  ``eval.py`` re-exports it.
- The bench's measuring function at a tiny configuration prints one JSON
  line with its keys and no ``vs_baseline``; without a GPU the entry prints
  a JSON line with ``error`` and exits 1.
"""

import json

import pytest
import torch

from torch_port_support import settle_inspect_module_walk, torch_threads, write_corpus
from rgbnomore_tpu_torch import bench, benchmark
from rgbnomore_tpu_torch import eval as port_eval
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders
from rgbnomore_tpu_torch.utils.timing import timed, timeit_fifo, timeit_fifo_carry


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return str(write_corpus(tmp_path_factory.mktemp("bench"), n=12, size=64))


def _tiny_cfg(batch=2):
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=batch)
    cfg.model.depth, cfg.model.classes = 1, 4
    cfg.model.dct_blocks, cfg.model.input_size = 8, 64
    return cfg


def test_timeit_fifo_orders_workloads():
    x = torch.ones((128, 128))

    def light(a):
        return a + 1.0

    def heavy(a):
        for _ in range(40):
            a = a @ a * (1.0 / 128.0)
        return a

    t_light = timeit_fifo(light, (x,), depth=8, repeats=2, warmup=1)
    t_heavy = timeit_fifo(heavy, (x,), depth=8, repeats=2, warmup=1)
    assert t_light > 0 and t_heavy > 0
    assert t_heavy > t_light


def test_timeit_fifo_carry_threads_state():
    calls = []

    def step(s):
        calls.append(1)
        return s + 1.0

    t = timeit_fifo_carry(step, torch.zeros(()), depth=4, repeats=2, warmup=1)
    assert t > 0
    # warmup 1 + 2 repeats x one window of 4 calls (the events time the
    # stream itself: no second depth to take a slope against)
    assert len(calls) == 1 + 2 * 4


@pytest.mark.parametrize("depth", [0, -3, 2.5])
def test_timing_checks_depths(depth):
    with pytest.raises(ValueError, match="depth"):
        timeit_fifo(lambda: torch.zeros(()), (), depth=depth)


def test_timed_returns_the_result_and_its_seconds():
    out, dt = timed(lambda: torch.ones(3).sum())
    assert float(out) == 3.0 and dt > 0


def test_dataloader_and_pipeline_on_the_corpus(corpus):
    cfg = _tiny_cfg()
    trainer = Trainer(cfg, device="cpu")
    loaders = make_loaders(cfg, corpus, corpus, num_threads=2,
                           global_batch=trainer.global_batch())
    settle_inspect_module_walk()
    trainer.create_state(max(1, len(loaders["train"])))
    n, dt = benchmark.benchmark_dataloader(loaders["test"], 3)
    assert n == 3 * 2 and dt > 0  # batches 1-3, the first left out
    n, dt = benchmark.benchmark_pipeline(trainer, loaders["test"], 2, "test")
    assert n == 2 * 2 and dt > 0
    step = trainer.step
    n, dt = benchmark.benchmark_pipeline(trainer, loaders["train"], 2, "train")
    assert n == 2 * 2 and dt > 0 and trainer.step == step + 3


@pytest.mark.parametrize("mode", ["fwd", "fbp"])
def test_model_synthetic_runs_300_iterations(mode):
    settle_inspect_module_walk()
    n, dt = benchmark.benchmark_model_synthetic(_tiny_cfg(), 1, mode, n_devices=1,
                                                device="cpu")
    assert n == 2 * 300 and dt > 0  # >= 300 iterations per the reference


def test_benchmark_model_returns_the_six_metrics(corpus):
    settle_inspect_module_walk()
    got = port_eval.benchmark_model(_tiny_cfg(), 1, corpus, corpus, num_threads=2, verbose=0,
                                    device="cpu")
    assert port_eval.benchmark_model is benchmark.benchmark_model
    assert set(got) == {"train_loader_fps", "test_loader_fps", "model_fbp_fps",
                        "model_fwd_fps", "train_pipeline_fps", "test_pipeline_fps"}
    assert all(v > 0 for v in got.values()), got


def test_bench_prints_one_json_line(corpus, capsys, monkeypatch):
    """The bench's measuring function at a tiny configuration (batch 2, 1 +
    3 x 2 steps, 2 device steps) on the CPU."""
    for name, value in (("SKIP", 1), ("WINDOWS", 3), ("PER_WINDOW", 2), ("DEVICE_STEPS", 2)):
        monkeypatch.setattr(bench, name, value)
    settle_inspect_module_walk()
    out = bench.run_bench(_tiny_cfg(), corpus, device="cpu", threads=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == {"metric", "value", "unit", "device_step_imgs_per_sec", "n_gpus",
                        "device"}
    assert out["metric"] == "jpeg_vitti_train_pipeline_imgs_per_sec_per_gpu"
    assert out["value"] > 0 and out["device_step_imgs_per_sec"] > 0
    assert out["n_gpus"] == 0 and out["device"] == "cpu"


def test_synthetic_dataset_is_the_jax_benchs(tmp_path):
    """The same 512x512 sinusoids from seed 0 as the JAX bench's corpus
    (``bench.py:44-67``), byte for byte, with the same labels."""
    import bench as jax_bench

    want = jax_bench.make_synthetic_dataset(tmp_path / "jax", 2)
    got = bench.make_synthetic_dataset(tmp_path / "port", 2)
    labels = [[ln.rsplit(",", 1)[1] for ln in p.read_text().splitlines()] for p in (got, want)]
    assert labels[0] == labels[1] == ["Label", "0", "1"]
    for i in range(2):
        assert (tmp_path / "port" / f"img_{i}.jpg").read_bytes() == \
            (tmp_path / "jax" / f"img_{i}.jpg").read_bytes()


def test_bench_without_a_gpu_prints_an_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "N_IMAGES", 2)
    monkeypatch.setattr(bench, "make_synthetic_dataset",
                        lambda root, n: write_corpus(root, n=n, size=32))
    assert bench.main([]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert len(lines) == 1 and "CUDA is not available" in got["error"]
    assert "value" not in got and "vs_baseline" not in got

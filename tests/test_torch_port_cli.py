"""The port's CLIs (``rgbnomore_tpu_torch/cli.py``, ``rgbnomore_tpu_torch/
eval.py``) on the CPU.

- The parser takes every flag of the JAX package's ``train.py`` under the
  same option strings, with the same default, type, choices and action,
  and adds ``--device`` (default ``cuda``).
- The flags ported since the first CLI (``--benchmark``, ``--stage_data``,
  ``--transfer packed/dense``, ``--embed_type 2/3``, ``--domain rgb``) run
  on the CPU: a step is trained and the weights written, or the six metrics
  returned; ``--stage_data`` stages ILSVRC-shaped tars first, which are then
  indexed and trained on.  The eval CLI forces ``--eval`` and drops
  ``--train``.
- ``python -m rgbnomore_tpu_torch.cli --train --eval --device cpu`` trains
  one epoch of the full-width ViT-Ti in a subprocess, writes its weights,
  and ``python -m rgbnomore_tpu_torch.eval --loadpath`` on them scores the
  run's test result again.
"""

import argparse
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_support import (
    settle_inspect_module_walk,
    torch_threads,
    write_corpus,
    write_imagenet_tars,
)
from rgbnomore_tpu_torch import cli
from rgbnomore_tpu_torch import eval as port_eval
from rgbnomore_tpu_torch.data.staging import build_index_csv

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """``train.py``'s parser, taken when its ``parse_args`` runs."""
    import train

    got = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        got["parser"] = self
        return parse(self, [], namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    train.parse_args()
    return got["parser"]


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_takes_every_flag_of_train_py(monkeypatch):
    want = _flags(_jax_parser(monkeypatch))
    got = _flags(cli.build_parser())
    assert len(want) >= 45 and set(got) == set(want) | {"device"}
    for dest, action in want.items():
        mine = got[dest]
        assert (mine.option_strings, mine.default, mine.type, mine.choices, type(mine)) == (
            action.option_strings, action.default, action.type, action.choices,
            type(action)), dest
    assert got["device"].default == "cuda" and got["device"].choices == ("cuda", "cpu")


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("cli_flags"), n=6, size=64)


def _tiny_benchmark_config(monkeypatch):
    """The CLI's config cut to depth 1 on an 8-block grid with 4 classes:
    the synthetic model benchmark runs 300 iterations each way."""
    from rgbnomore_tpu_torch.train import config

    full = config.generate_config

    def tiny(*a, **kw):
        cfg = full(*a, **kw)
        cfg.model.depth, cfg.model.classes = 1, 4
        cfg.model.dct_blocks, cfg.model.input_size = 8, 64
        return cfg

    monkeypatch.setattr(config, "generate_config", tiny)


BENCHMARK_KEYS = {"train_loader_fps", "test_loader_fps", "model_fbp_fps", "model_fwd_fps",
                  "train_pipeline_fps", "test_pipeline_fps"}


@pytest.mark.parametrize("argv", [
    ["--benchmark", "1", "--model_arch", "vitti", "--embed_type", "1"],
    ["--stage_data", "--model_arch", "vitti", "--embed_type", "1"],
    ["--transfer", "packed", "--model_arch", "vitti", "--embed_type", "1"],
    ["--transfer", "dense", "--model_arch", "vitti", "--embed_type", "1"],
    ["--domain", "rgb"],  # the CLI's defaults in the RGB domain: ViT-S/16
    ["--embed_type", "2"],  # the CLI's defaults: ViT-S/16, embed_type 2
    ["--embed_type", "3", "--model_arch", "vitti"],
], ids=["benchmark", "stage_data", "packed", "dense", "rgb", "embed2", "embed3"])
def test_unported_flags_raise(argv, small_corpus, tmp_path, monkeypatch, caplog):
    """The flags once in the port's queue now run on the CPU: the benchmark
    returns the six metrics, each > 0; a transfer, an embedding or the RGB
    domain trains one step at full width, writes the weights and scores the
    test split; ``--stage_data`` stages 2 classes of 3 JPEGs and 2 val
    images (resized to 512x512), which are indexed and trained on so, at
    ``--verbose 2``: the model summary is logged with ViT-Ti's parameter
    count."""
    indexpaths, test_count = f"{small_corpus},{small_corpus}", 6
    if argv[0] == "--stage_data":
        src = write_imagenet_tars(tmp_path, np.random.default_rng(0), per_class=3,
                                  size=(96, 64))
        staged = tmp_path / "staged"
        assert cli.main(["--stage_data", "--datapath", str(src), "--temp_datapath",
                         str(staged), "--num_cpus", "2", "--device", "cpu"]) == {}
        for split, n in (("train", 6), ("val", 2)):
            assert build_index_csv(staged, tmp_path / f"{split}.csv", split) == n
        indexpaths, test_count = f"{tmp_path / 'train.csv'},{tmp_path / 'val.csv'}", 2
        argv = argv[1:] + ["--verbose", "2"]
        caplog.set_level(logging.INFO, logger="rgbnomore_tpu_torch.train.loop")
    common = ["--device", "cpu", "--indexpaths", indexpaths,
              "--batch", "2", "--num_cpus", "2", "--verbose", "0"]
    settle_inspect_module_walk()  # each case builds a torch.optim optimizer
    if argv[0] == "--benchmark":
        _tiny_benchmark_config(monkeypatch)
        got = cli.main(common + argv)
        assert set(got) == BENCHMARK_KEYS and all(v > 0 for v in got.values()), got
        return
    weights = tmp_path / "w.pt"
    got = cli.main(common + ["--train", "--eval", "--epochs", "1", "--max_steps_per_epoch",
                             "1", "--savepath", str(weights)] + argv)
    assert got["test"]["count"] == test_count and len(got["history"]) == 1
    if argv[-2:] == ["--verbose", "2"]:
        assert "Total Parameters: 5,642,728 " in caplog.text  # ViT-Ti, embed_type 1
    assert np.isfinite(got["history"][0]["train_loss"])
    state = torch.load(weights, weights_only=True)
    if "rgb" in argv:  # vits on pixels: a 16x16 stride-16 convolution to 384
        assert state["patchembed.projection.weight"].shape == (384, 3, 16, 16)
    elif argv == ["--embed_type", "2"]:  # vits: 384 = 256 luma + 128 chroma features
        assert state["patchembed.projection_y.weight"].shape == (256, 256)
        assert state["patchembed.projection_c.weight"].shape == (128, 128)
        assert state["patchembed.linear_mix.weight"].shape == (384, 384)
    elif "3" in argv:
        assert state["patchembed.projection_c.weight"].shape == (192, 256)
    else:
        assert state["patchembed.projection.weight"].shape == (192, 384)


@pytest.mark.parametrize("argv", [["--train", "--model_arch", "vitti"],
                                  ["--model_arch", "vitti", "--eval", "--train"],
                                  ["--model_arch", "vitti"]])
def test_eval_cli_forces_eval_and_drops_train(monkeypatch, argv):
    seen = []
    monkeypatch.setattr(cli, "main", lambda a: seen.append(a) or {})
    port_eval.main(argv)
    assert "--train" not in seen[0] and seen[0].count("--eval") == 1
    assert [a for a in seen[0] if a != "--eval"] == [a for a in argv if a not in ("--train",
                                                                                  "--eval")]


def _run(module: str, args: list[str], cwd: Path) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + ([env["PYTHONPATH"]]
                                                       if env.get("PYTHONPATH") else []))
    res = subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = res.communicate(timeout=600)
    finally:
        if res.poll() is None:
            res.kill()
    assert res.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_cpu_run_trains_saves_and_reevaluates(tmp_path):
    """ViT-Ti at full width (28x28 blocks) on 12 JPEGs, batch 4, one epoch
    capped at 2 steps, then the eval CLI on its weights file."""
    index = write_corpus(tmp_path, n=12, size=96)
    common = ["--model_arch", "vitti", "--embed_type", "1", "--indexpaths",
              f"{index},{index}", "--device", "cpu", "--num_cpus", "2", "--batch", "4",
              "--verbose", "0"]
    weights = tmp_path / "models" / "vitti.pt"
    trained = _run("rgbnomore_tpu_torch.cli",
                   ["--train", "--eval", "--epochs", "1", "--max_steps_per_epoch", "2",
                    "--savepath", str(weights), "--drop", "0.1", *common], tmp_path)
    assert weights.is_file() and trained["test"]["count"] == 12
    assert (tmp_path / "models" / "checkpoints" / "vitti_dct" / "epoch_0.pt").is_file()
    rescored = _run("rgbnomore_tpu_torch.eval",
                    ["--train", "--loadpath", str(weights), *common], tmp_path)
    assert rescored["test"] == trained["test"]
    assert "history" not in rescored  # --train was dropped: no training

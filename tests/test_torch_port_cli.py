"""The port's CLIs (``rgbnomore_tpu_torch/cli.py``, ``rgbnomore_tpu_torch/
eval.py``) on the CPU.

- The parser takes every flag of the JAX package's ``train.py`` under the
  same option strings, with the same default, type, choices and action,
  and adds ``--device`` (default ``cuda``).
- Each flag whose feature is still in the port's queue raises
  ``NotImplementedError`` naming its ROADMAP module; the eval CLI forces
  ``--eval`` and drops ``--train``.
- ``python -m rgbnomore_tpu_torch.cli --train --eval --device cpu`` trains
  one epoch of the full-width ViT-Ti in a subprocess, writes its weights,
  and ``python -m rgbnomore_tpu_torch.eval --loadpath`` on them scores the
  run's test result again.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_port_support import torch_threads, write_corpus
from rgbnomore_tpu_torch import cli
from rgbnomore_tpu_torch import eval as port_eval

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


@pytest.mark.parametrize("argv,module", [
    (["--benchmark", "10"], "module 4"),
    (["--stage_data"], "module 7"),
    (["--transfer", "packed"], "module 5"),
    (["--transfer", "dense"], "module 5"),
    (["--domain", "rgb"], "module 6"),
    (["--embed_type", "2"], "module 5"),
    (["--embed_type", "3"], "module 5"),
], ids=["benchmark", "stage_data", "packed", "dense", "rgb", "embed2", "embed3"])
def test_unported_flags_raise(argv, module):
    argv = ["--embed_type", "1", "--train", "--device", "cpu"] + argv
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, port queue: {module}"):
        cli.main(argv)


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

"""The port's checkpoints (``train/checkpoint.py``), on the CPU.

- A save / restore round trip gives back every field bit for bit: the
  parameters, AdamW's moments and count, the schedule's count, fp16's loss
  scale, both host generators, the epoch and the metrics; the next step of
  the restored Trainer is the original's.
- Exact resume: ``train_and_eval`` for 2 epochs straight against 1 epoch,
  a stop, a restore and the 2nd epoch, at drop 0.1 with mixup: the last
  checkpoints' parameters and AdamW state bit-identical.
- ``latest_checkpoint_step`` reads the epochs as numbers and ignores a
  half-written file; ``ckpt_every`` thins the cadence and keeps the last
  epoch.
"""

import numpy as np
import pytest
import torch

from torch_port_support import (
    settle_inspect_module_walk,
    synthetic_planes,
    torch_threads,
    write_corpus,
    write_rows,
)
from rgbnomore_tpu_torch.train import checkpoint as ckpt
from rgbnomore_tpu_torch.train import loop
from rgbnomore_tpu_torch.train.config import generate_config
from rgbnomore_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("ckpt_corpus"))


def _cfg(epochs=2, drop=0.1, amp=False):
    cfg = generate_config("vitti", "dct", modelver=1, batchsize=4, warmup_steps=2,
                          epochs=epochs, drop=drop, amp=amp, ampdtype="fp16", lr=3e-3)
    cfg.model.depth, cfg.model.dct_blocks, cfg.model.classes = 2, 8, 4
    cfg.train.split = 0.25
    cfg.train.auglist = ["Brightness", "Cutout", "TranslateX"]
    return cfg


def _rows(rng, n=4):
    y, c = synthetic_planes(rng, n, 8)
    return write_rows(y, c, (np.arange(n) % 4).astype(np.int32), 16)


def _opt_state_equal(a: dict, b: dict) -> bool:
    if a["param_groups"] != b["param_groups"] or a["state"].keys() != b["state"].keys():
        return False
    return all(a["state"][i].keys() == b["state"][i].keys()
               and all(torch.equal(a["state"][i][k], b["state"][i][k]) for k in a["state"][i])
               for i in a["state"])


def _state_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_round_trip_restores_every_field(tmp_path, rng):
    """fp16 (so the loss scaler has a state) at drop 0.1: two steps, a save,
    a restore into a Trainer that has taken a step of its own on other
    rows, then one more step on each."""
    settle_inspect_module_walk()
    rows = torch.from_numpy(_rows(rng))
    src = Trainer(_cfg(amp=True), device="cpu")
    src.create_state(steps_per_epoch=5)
    for _ in range(2):
        src.train_step(rows)
    src.loss_scale.good_steps += 7  # a count no fresh state has
    path = ckpt.save_checkpoint(tmp_path, src, 3, {"val_acc": 0.25, "train_loss": 1.5})
    assert path == (tmp_path / "epoch_3.pt").resolve() and path.is_file()

    dst = Trainer(_cfg(amp=True), device="cpu")
    dst.create_state(steps_per_epoch=5)
    dst.train_step(torch.from_numpy(_rows(rng)))
    meta = ckpt.restore_checkpoint(tmp_path, dst)
    assert meta == {"epoch": 3, "metrics": {"val_acc": 0.25, "train_loss": 1.5}}
    assert _state_equal(dst.model.state_dict(), src.model.state_dict())
    assert _opt_state_equal(dst.optimizer.opt.state_dict(), src.optimizer.opt.state_dict())
    assert dst.optimizer.count == src.optimizer.count == 2
    assert torch.equal(dst.loss_scale.scale, src.loss_scale.scale)
    assert int(dst.loss_scale.good_steps) == int(src.loss_scale.good_steps) == 9
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    assert dst.rng.bit_generator.state == src.rng.bit_generator.state
    # the same next draws, masks and step
    d_src, d_dst = src.draw(4), dst.draw(4)
    assert torch.equal(d_src.flip, d_dst.flip) and d_src.lam == d_dst.lam
    assert all(torch.equal(a, b) for a, b in zip(d_src.policy, d_dst.policy))
    assert torch.equal(src.train_step(rows, d_src), dst.train_step(rows, d_dst))
    assert _state_equal(dst.model.state_dict(), src.model.state_dict())


def test_restore_without_a_checkpoint_raises(tmp_path):
    trainer = Trainer(_cfg(), device="cpu")
    trainer.create_state(steps_per_epoch=1)
    with pytest.raises(FileNotFoundError, match="No checkpoints"):
        ckpt.restore_checkpoint(tmp_path / "none", trainer)


class Preempted(Exception):
    """Stops a run right after its first checkpoint, as a lost job would."""


def _train(corpus, out, **kw):
    return loop.train_and_eval(_cfg(), str(corpus), str(corpus), savepath=str(out / "w.pt"),
                               num_threads=2, verbose=0, device="cpu", **kw)


def test_resume_is_bit_identical_to_a_straight_run(corpus, tmp_path, monkeypatch):
    settle_inspect_module_walk()
    straight = _train(corpus, tmp_path / "straight")
    assert [h["epoch"] for h in straight["history"]] == [0, 1]

    save = ckpt.save_checkpoint

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise Preempted

    with monkeypatch.context() as mp:
        mp.setattr(ckpt, "save_checkpoint", save_then_stop)
        with pytest.raises(Preempted):
            _train(corpus, tmp_path / "resumed")
    ckpt_dir = ckpt.checkpoint_dir(str(tmp_path / "resumed" / "w.pt"), "vitti_dct")
    assert ckpt.latest_checkpoint_step(ckpt_dir) == 0
    resumed = _train(corpus, tmp_path / "resumed", load_ckpt_dir=str(ckpt_dir))
    assert [h["epoch"] for h in resumed["history"]] == [1]

    want = torch.load(ckpt.checkpoint_dir(str(tmp_path / "straight" / "w.pt"), "vitti_dct")
                      / "epoch_1.pt", weights_only=True)
    got = torch.load(ckpt_dir / "epoch_1.pt", weights_only=True)
    assert got["count"] == want["count"] == 6  # 3 steps an epoch
    assert _state_equal(got["model"], want["model"])
    assert _opt_state_equal(got["optimizer"], want["optimizer"])
    assert torch.equal(got["generator"], want["generator"]) and got["rng"] == want["rng"]
    assert resumed["test"] == straight["test"]
    weights = torch.load(tmp_path / "resumed" / "w.pt", weights_only=True)
    assert _state_equal(weights, want["model"])


def test_latest_checkpoint_step(tmp_path):
    assert ckpt.latest_checkpoint_step(tmp_path / "missing") is None
    assert ckpt.latest_checkpoint_step(tmp_path) is None
    for name in ("epoch_2.pt", "epoch_10.pt", "epoch_11.pt.tmp", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint_step(tmp_path) == 10


@pytest.mark.parametrize("every,saved", [(1, [0, 1, 2]), (2, [1, 2]), (5, [2])])
def test_ckpt_every_keeps_the_last_epoch(corpus, tmp_path, every, saved):
    settle_inspect_module_walk()
    cfg = _cfg(epochs=3, drop=0.0)
    loop.train_and_eval(cfg, str(corpus), str(corpus), savepath=str(tmp_path / "w.pt"),
                        num_threads=2, verbose=0, device="cpu", max_steps_per_epoch=1,
                        ckpt_every=every, run_eval=False)
    ckpt_dir = ckpt.checkpoint_dir(str(tmp_path / "w.pt"), "vitti_dct")
    assert sorted(int(p.stem.split("_")[1]) for p in ckpt_dir.glob("epoch_*.pt")) == saved

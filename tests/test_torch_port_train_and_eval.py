"""The port's ``train_and_eval`` against the JAX package's, on the CPU.

- Eval-only mode on the JAX Trainer's parameters: the JAX side saves them
  with its ``save_params`` (flax msgpack) and scores them with its
  ``train_and_eval(run_train=False)``; the port scores their ``convert.py``
  mapping, saved as a ``state_dict``, with its own.  Test, minival and
  trainval agree as the eval tests hold them (``tests/
  test_torch_port_eval.py``): the count and the number correct exactly,
  the summed loss at rtol 1e-5, on the default eval wire and on K=32
  mask16w.  ``evaluate_model`` gives the same.
- ``packed_k`` and ``train_fmt`` reach both ends of the train wire.
- A training run writes the JAX loop's TensorBoard tags
  (``rgbnomore_tpu/train/loop.py:601-649``) with the port's host split
  (``Host/<span>_s``, each the epoch's seconds in that span) and its
  weights file, a bare ``state_dict`` of the trained model that eval-only
  mode scores to the run's own test result.
"""

import jax
import numpy as np
import pytest
import torch

from rgbnomore_tpu.models import embeddings as jax_embeddings
from rgbnomore_tpu.train import loop as jax_loop
from rgbnomore_tpu.train.config import generate_config as jax_generate_config
from torch_port_support import settle_inspect_module_walk, torch_threads, write_corpus
from rgbnomore_tpu_torch.convert import flax_to_state_dict
from rgbnomore_tpu_torch.eval import evaluate_model
from rgbnomore_tpu_torch.train import loop
from rgbnomore_tpu_torch.train.config import generate_config

# the scalars of the JAX loop: per logged step, per epoch, after the test
# eval; and the port's per-epoch host split (``loop.EPOCH_HOST_SPANS``)
TAGS = {"Loss/Peritr_Train", "Loss/Train", "Loss/Val", "Acc/Val", "Loss/Train_val",
        "Acc/Train_val", "Learning Rate", "Acc/Test", "Loss/Test", "Host/loader.wait_s",
        "Host/upload_s", "Host/step_s", "Host/loss_read_s", "Host/eval_s", "Host/checkpoint_s"}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # 40 files: minival 4 (split 0.1), trainval 2 of the other 36
    return write_corpus(tmp_path_factory.mktemp("tae_corpus"), n=40)


def _cfg(gen):
    cfg = gen("vitti", "dct", modelver=1, batchsize=8, epochs=1, warmup_steps=2)
    cfg.model.depth, cfg.model.dct_blocks, cfg.model.classes = 1, 8, 4
    cfg.train.split = 0.1
    cfg.train.auglist = ["Brightness", "Cutout", "TranslateX"]
    return cfg


def _same(got: dict, want: dict) -> None:
    assert got["count"] == want["count"]
    assert got["accuracy"] * got["count"] == want["accuracy"] * want["count"]
    np.testing.assert_allclose(got["loss"] * got["count"], want["loss"] * want["count"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """The JAX Trainer's seeded parameters, saved by its ``save_params``
    (flax msgpack) and, mapped by ``convert.py``, as the port's
    ``state_dict``."""
    jax_embeddings.set_bias_family("torch")
    out = tmp_path_factory.mktemp("tae_jax")
    trainer = jax_loop.Trainer(_cfg(jax_generate_config), devices=jax.devices()[:1],
                               transfer="cropped")
    trainer.create_state(steps_per_epoch=1)
    params = jax.tree.map(np.asarray, trainer.state.params)
    jax_loop.save_params(out / "w.msgpack", params)
    torch.save(flax_to_state_dict(params), out / "w.pt")
    return out / "w.msgpack", out / "w.pt"


# the eval wire of the cropped transfer: the default, and int16 ACs at K=32
@pytest.mark.parametrize("k_eval,fmt", [(None, None), (32, "mask16w")],
                         ids=["default", "mask16w"])
def test_eval_only_matches_jax(corpus, jax_params, tmp_path, k_eval, fmt):
    msgpack, weights = jax_params
    wire = dict(packed_k_eval=k_eval, eval_fmt=fmt, num_threads=2, verbose=0)
    want = jax_loop.train_and_eval(_cfg(jax_generate_config), str(corpus), str(corpus),
                                   savepath=str(tmp_path / "unused"), loadpath=str(msgpack),
                                   run_train=False, transfer="cropped", num_devices=1, **wire)
    got = loop.train_and_eval(_cfg(generate_config), str(corpus), str(corpus),
                              loadpath=str(weights), run_train=False, device="cpu", **wire)
    assert got.keys() == want.keys() == {"test", "val", "trainval"}
    assert (got["test"]["count"], got["val"]["count"], got["trainval"]["count"]) == (40, 4, 2)
    for split in ("test", "val", "trainval"):
        _same(got[split], want[split])
    again = evaluate_model(_cfg(generate_config), str(corpus), str(corpus), str(weights),
                           device="cpu", **wire)
    assert again == got


def test_train_wire_reaches_loader_and_trainer(corpus, tmp_path):
    """``packed_k`` and ``train_fmt`` go to both ends of the train wire (a
    row of the wrong layout would not unpack): one step on K=8 mask16q."""
    settle_inspect_module_walk()
    res = loop.train_and_eval(_cfg(generate_config), str(corpus), str(corpus),
                              savepath=str(tmp_path / "w.pt"), max_steps_per_epoch=1,
                              packed_k=8, train_fmt="mask16q", num_threads=2, verbose=0,
                              run_eval=False, device="cpu")
    assert np.isfinite(res["history"][0]["train_loss"]) and res["trainval"]["count"] == 2


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    settle_inspect_module_walk()
    out = tmp_path_factory.mktemp("tae_run")
    results = loop.train_and_eval(_cfg(generate_config), str(corpus), str(corpus),
                                  savepath=str(out / "vitti.pt"), max_steps_per_epoch=2,
                                  num_threads=2, verbose=0, device="cpu")
    return results, out


def test_training_writes_the_tensorboard_tags(trained):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    results, out = trained
    logdir = loop.tensorboard_dir(str(out / "vitti.pt"), _cfg(generate_config))
    assert logdir == out / "tb_logs" / "vitti_lr0.003_wd0.0001_drop0.0"
    events = EventAccumulator(str(logdir))
    events.Reload()
    assert set(events.Tags()["scalars"]) == TAGS
    assert events.Scalars("Acc/Test")[0].value == pytest.approx(results["test"]["accuracy"])
    assert events.Scalars("Loss/Val")[0].value == pytest.approx(results["val"]["loss"])
    assert all(events.Scalars(f"Host/{name}_s")[0].value > 0 for name in loop.EPOCH_HOST_SPANS)


def test_training_writes_the_weights_file(corpus, trained):
    results, out = trained
    state = torch.load(out / "vitti.pt", weights_only=True)
    model = loop.Trainer(_cfg(generate_config), device="cpu").model
    assert state.keys() == model.state_dict().keys()
    assert results["history"][0]["train_img_s"] > 0 and results["epoch"] == 0
    rescored = evaluate_model(_cfg(generate_config), str(corpus), str(corpus),
                              str(out / "vitti.pt"), device="cpu", num_threads=2, verbose=0)
    assert rescored["test"] == results["test"]

"""The port's data parallelism on the CPU: two gloo processes against one.

The property the JAX package's sharding tests hold (``tests/
test_distributed.py:90-114``, ``__graft_entry__._dryrun_body``): N
processes on one global batch compute what one process computes on it.
Two ranks (``tests/_torch_dp_worker.py``), each on its half of the same
global-batch rows, against one process on the whole of them, for the ViT
with mixup (whose pairs roll across the ranks) and SwinV2 with mixup and
drop path, at ``--drop 0`` (dropout's masks are per rank):

- the losses of three steps, averaged over the ranks, at rtol 2e-5 /
  atol 2e-6;
- every parameter after them at atol 3e-4 (AdamW turns reduction-order
  noise into moves up to the learning rate's scale);
- the eval sums of the test split through the sharded loaders: the count
  and the accuracy exactly, the loss at rtol 2e-5.

Also: the shards of the port's loader partition an epoch, and in a
``train_and_eval`` run of two ranks rank 0 alone writes (weights,
checkpoint, TensorBoard).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_support import settle_inspect_module_walk, torch_threads, write_corpus
import _torch_dp_worker as worker
from rgbnomore_tpu_torch.data.index import load_index
from rgbnomore_tpu_torch.data.loader import DctCroppedLoader

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 synthetic 64x64 JPEGs across 4 classes (``tests/test_distributed.py``'s)."""
    root = tmp_path_factory.mktemp("dp_corpus")
    write_corpus(root)
    return root


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    """Run the two workers; their JSON lines and saved results."""
    out = tmp_path_factory.mktemp("dp_out")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_dp_worker.py"), str(corpus), str(out),
         str(rank), "2", str(port)], env=env, cwd=out, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    lines = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
            lines.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return lines, ranks, out


@pytest.fixture(scope="module")
def one_process(corpus):
    settle_inspect_module_walk()
    return {name: worker.run_case(name, corpus) for name in worker.CASES}


@pytest.mark.parametrize("case", sorted(worker.CASES))
def test_two_ranks_losses_match_one_process(two_ranks, one_process, case):
    _, ranks, _ = two_ranks
    got = np.mean([r[case]["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, one_process[case]["losses"], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", sorted(worker.CASES))
def test_two_ranks_parameters_match_one_process(two_ranks, one_process, case):
    _, ranks, _ = two_ranks
    want = one_process[case]["params"]
    for r in ranks:
        assert r[case]["params"].keys() == want.keys()
    for key, w in want.items():
        # every rank takes the same averaged step: the replicas stay equal
        assert torch.equal(ranks[0][case]["params"][key], ranks[1][case]["params"][key]), key
        np.testing.assert_allclose(ranks[0][case]["params"][key].numpy(), w.numpy(), atol=3e-4,
                                   err_msg=key)


@pytest.mark.parametrize("case", sorted(worker.CASES))
def test_two_ranks_eval_sums_match_one_process(two_ranks, one_process, case):
    _, ranks, _ = two_ranks
    want = one_process[case]["eval"]
    assert want["count"] == 16.0
    for r in ranks:
        got = r[case]["eval"]
        assert got["count"] == want["count"] and got["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)


def test_rank0_alone_writes(two_ranks):
    """Rank 0 writes the checkpoint and the weights (two ``torch.save``
    calls) and the one TensorBoard event file; rank 1 writes nothing."""
    lines, _, out = two_ranks
    assert [line["world"] for line in lines] == [2, 2]
    assert [line["saves"] for line in lines] == [2, 0]
    assert lines[0]["events"] == 1
    assert (out / "run" / "w.pt").is_file()
    assert [p.name for p in (out / "run" / "checkpoints" / "vitti_dct").iterdir()] == [
        "epoch_0.pt"]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("train", [True, False])
def test_loader_shards_partition_an_epoch(corpus, world, train):
    """The ranks' shards of one epoch: train shards (shuffled, padded by
    wrapping to equal length) cover every example, and no example twice
    beyond the padding; eval shards hold every example exactly once, padded
    with weight-0 sentinels (-1) to one length, so every rank runs the same
    number of batches."""
    ds = load_index(corpus / "index.csv").subset(np.arange(13))
    shards = [DctCroppedLoader(ds, 4, target=8, mode="train" if train else "center",
                               shuffle=train, drop_last=train, seed=3, shard_id=r,
                               num_shards=world) for r in range(world)]
    for s in shards:
        s.set_epoch(2)
    idx = [s._epoch_indices() for s in shards]
    assert len({len(i) for i in idx}) == 1 and len({len(s) for s in shards}) == 1
    flat = np.concatenate(idx)
    real = flat[flat >= 0]
    assert sorted(set(real.tolist())) == list(range(13))
    pad = len(flat) - 13
    assert pad == (-13) % world
    if train:
        assert len(real) == len(flat)  # padded with repeats of the order's head
    else:
        assert len(real) == 13 and (flat < 0).sum() == pad

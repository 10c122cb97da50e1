"""Worker of ``tests/test_torch_port_distributed.py``: one rank of the
port's data-parallel trainer on the CPU (gloo).

    python _torch_dp_worker.py <corpus_dir> <out_dir> <rank> <world> <port>

Joins the process group at ``localhost:<port>`` and runs, for the ViT and
for SwinV2 with drop path, three train steps on this rank's rows of the
global batches that :func:`global_batches` gives, and the eval of the test
split through the sharded loaders; writes its losses, parameters and eval
to ``<out_dir>/rank<rank>.pt``.  Then one epoch of ``train_and_eval``,
counting this rank's ``torch.save`` calls and TensorBoard event files.
Prints one JSON line.  :func:`run_case` with no process group is the
one-process reference the test holds the ranks against.
"""

import json
import sys
from pathlib import Path

import torch

GLOBAL_BATCH = 8
STEPS = 3


def vit_cfg():
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=GLOBAL_BATCH, warmup_steps=2,
                          epochs=1)
    cfg.model.depth, cfg.model.dct_blocks, cfg.model.classes = 2, 8, 4
    cfg.train.split = 0.25
    cfg.train.auglist = ["Brightness", "Cutout", "TranslateX"]
    return cfg


def swin_cfg():
    from torch_port_support import tiny_swin_cfg

    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = tiny_swin_cfg(generate_config, batch=GLOBAL_BATCH, classes=4, drop_path=0.2)
    cfg.train.split = 0.25
    cfg.train.auglist = ["Brightness", "Cutout", "TranslateX"]
    return cfg


CASES = {"vit": vit_cfg, "swin": swin_cfg}


def global_batches(cfg, corpus: Path) -> list:
    """The first ``STEPS`` global batches of the train split, from one
    unsharded loader: the rows every run, one process or N, trains on."""
    from rgbnomore_tpu_torch.data.index import load_index, split_train_minival
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader

    train, _, _ = split_train_minival(load_index(corpus / "index.csv"), split=cfg.train.split,
                                      seed=cfg.seed)
    ldr = DctCroppedLoader(train, GLOBAL_BATCH, target=cfg.model.dct_blocks, k=16,
                           mode="train", shuffle=True, drop_last=True, seed=cfg.seed,
                           num_threads=2)
    return [b["packed"] for b in ldr.iter_cycle(STEPS)]


def run_case(name: str, corpus: Path) -> dict:
    """Eval of the test split at init, then ``STEPS`` train steps on this
    rank's slice of each global batch."""
    from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

    cfg = CASES[name]()
    trainer = Trainer(cfg, device="cpu")
    index = str(corpus / "index.csv")
    evals = trainer.evaluate(make_loaders(cfg, index, index, num_threads=2)["test"])
    trainer.create_state(steps_per_epoch=10)
    b = trainer.cfg.train.batch_per_device
    losses = []
    for rows in global_batches(cfg, corpus):
        mine = rows[trainer.rank * b:(trainer.rank + 1) * b]
        losses.append(float(trainer.train_step(trainer.put_batch({"packed": mine})["packed"])))
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return {"losses": losses, "params": params, "eval": evals}


def count_writes(corpus: Path, out: Path) -> dict:
    """One epoch of ``train_and_eval`` (one step), counting this rank's
    ``torch.save`` calls; the TensorBoard event files under the run."""
    from rgbnomore_tpu_torch.train import loop

    calls = []
    save = torch.save

    def counted(obj, f, *a, **kw):
        calls.append(str(f))
        return save(obj, f, *a, **kw)

    torch.save = counted
    try:
        loop.train_and_eval(vit_cfg(), str(corpus / "index.csv"), str(corpus / "index.csv"),
                            savepath=str(out / "run" / "w.pt"), max_steps_per_epoch=1,
                            num_threads=2, verbose=0, device="cpu")
    finally:
        torch.save = save
    return {"saves": len(calls),
            "events": len(list((out / "run" / "tb_logs").rglob("events.out.tfevents*")))}


def main() -> None:
    corpus, out = Path(sys.argv[1]), Path(sys.argv[2])
    rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(2)
    from rgbnomore_tpu_torch import parallel

    parallel.init_distributed(f"localhost:{port}", num_processes=world, process_id=rank,
                              device="cpu")
    assert parallel.world_size() == world and parallel.rank() == rank
    results = {name: run_case(name, corpus) for name in CASES}
    torch.save(results, out / f"rank{rank}.pt")
    writes = count_writes(corpus, out)
    parallel.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "world": world, **writes}))


if __name__ == "__main__":
    main()

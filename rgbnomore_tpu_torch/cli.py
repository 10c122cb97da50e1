"""Train / evaluate CLI of the port, with the flags of the JAX package's
``train.py`` (``train.py:17-112``) under the same names and defaults, and
``--device`` (default ``cuda``; ``cpu`` trains on the CPU).

One GPU, the defaults (ViT-S/16 with the separate sub-block DCT embedding,
embed_type 2):

    python -m rgbnomore_tpu_torch.cli --train --eval \\
        --indexpaths train.csv,val.csv --savepath models/vits.pt

``--benchmark N`` runs the six FPS metrics of ``benchmark.py`` for N
iterations instead (loaders, the model on synthetic inputs, the pipelines).

Data parallel, one process per GPU over NCCL: ``torchrun --nproc_per_node N
-m rgbnomore_tpu_torch.cli ...``, or N processes started by hand with
``--coordinator host:port --num_processes N --process_id R``.  ``--batch``
is the global batch.  ``--load_ckpt <dir(savepath)>/checkpoints/<arch>_dct``
resumes from the last checkpoint there.  ``python -m
rgbnomore_tpu_torch.eval`` is this CLI with ``--eval`` forced.

``--domain rgb`` trains the paper's RGB baseline: the same models on pixels
decoded on the device from K=63 coefficient rows, with ``AUGLIST_RGB`` at
magnitude 10, lr 1e-3 and wd 1e-4 unless the flags say otherwise.
``--transfer`` takes ``cropped`` (the default), ``packed`` or ``dense``.

``--stage_data`` stages ImageNet first (``data/staging.py``): the tars in
``--datapath`` are extracted into ``--temp_datapath`` (``--no_extract``
keeps a tree already there, ``--use_msrsync`` copies one instead), the val
images are moved into their class directories and every image is resized
to 512x512 4:2:0 (``--no_resize`` skips that); ``data.staging.
build_index_csv`` then writes the index CSVs.  ``--verbose 2`` logs the
model summary (``utils/summary.py``).

The weights are a bare ``state_dict`` written by ``torch.save`` whatever
``--savepath``'s extension; checkpoints are ``torch.save`` files
(``train/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m rgbnomore_tpu_torch.cli",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # model config
    p.add_argument("--model_arch", type=str, default="vits",
                   help="Model architecture (vitti, vits, vitb, vitl, swinv2)")
    p.add_argument("--no_subblock", action="store_true", help="Disable subblock conversion")
    p.add_argument("--embed_type", type=int, default=2,
                   help="Embedding type: 1 grouped, 2 separate, 3 concatenate")
    p.add_argument("--domain", type=str, default="dct", help="(DCT/RGB) input domain")
    # data config
    p.add_argument("--datapath", type=str, default="./imagenet",
                   help="Folder containing the ImageNet .tar files (--stage_data)")
    p.add_argument("--temp_datapath", type=str, default="/tmp/imagenet_data",
                   help="Where the dataset is staged (--stage_data, --delete_dataset)")
    p.add_argument("--indexpaths", type=str, default="assets/index_train.csv,assets/index_val.csv",
                   help="train,val index CSVs (comma separated)")
    p.add_argument("--delete_dataset", action="store_true",
                   help="Delete --temp_datapath after the run")
    p.add_argument("--no_extract", action="store_true")
    p.add_argument("--no_resize", action="store_true")
    p.add_argument("--num_devices", "--num_gpus", type=int, default=-1,
                   help="GPUs of the run: the process group's world size (-1: as it is)")
    p.add_argument("--num_cpus", type=int, default=4, help="Host threads for the loader")
    p.add_argument("--use_msrsync", action="store_true")
    p.add_argument("--stage_data", action="store_true",
                   help="Stage the dataset from --datapath's tars into --temp_datapath")
    # pipeline config
    p.add_argument("--train", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--benchmark", type=int, default=0,
                   help="Benchmark for N iterations (the six FPS metrics)")
    p.add_argument("--savepath", type=str, default="./models/ViT_v1.msgpack",
                   help="Final weights (a torch state_dict); checkpoints go beside it")
    p.add_argument("--loadpath", type=str, default="")
    p.add_argument("--load_ckpt", type=str, default="",
                   help="Checkpoint directory to resume from (its last epoch)")
    p.add_argument("--transfer", type=str, default="",
                   choices=("", "cropped", "packed", "dense"),
                   help="Host->device format: 'cropped' (the default), 'packed' or "
                        "'dense'")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--verbose", type=int, default=1, help="0/1/2 logging verbosity")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="Checkpoint every N epochs (always keeps the final one)")
    p.add_argument("--packed_k", type=int, default=0,
                   help="Top-K AC coefficients per block on the train wire (0 = 16)")
    p.add_argument("--packed_k_eval", type=int, default=0,
                   help="Top-K on the eval wire (0 = 48)")
    p.add_argument("--eval_fmt", type=str, default="", choices=("", "mask16", "mask16w"),
                   help="Eval wire value format: mask16 (int8 ACs, default) or mask16w "
                        "(int16 ACs)")
    p.add_argument("--train_fmt", type=str, default="", choices=("", "mask16", "mask16w",
                                                                  "mask16q"),
                   help="Train wire value format: mask16 (default), mask16w or mask16q")
    # process group rendezvous: torchrun's environment, or these three
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0 (torch.distributed TCP rendezvous); "
                        "empty = torchrun's environment, or one process")
    p.add_argument("--num_processes", type=int, default=-1,
                   help="Total process count for --coordinator")
    p.add_argument("--process_id", type=int, default=-1,
                   help="This process's rank for --coordinator")
    # hyperparameter overrides (-1 / '' sentinel = use preset)
    p.add_argument("--epochs", type=int, default=-1)
    p.add_argument("--batch", type=int, default=-1, help="Global batch over every process")
    p.add_argument("--lr", type=float, default=-1)
    p.add_argument("--wd", type=float, default=-1)
    p.add_argument("--drop", type=float, default=-1)
    p.add_argument("--warmup_steps", type=int, default=-1)
    p.add_argument("--ops_list", type=str, default="")
    p.add_argument("--num_ops", type=int, default=-1)
    p.add_argument("--ops_magnitude", type=int, default=-1)
    p.add_argument("--amp", type=int, default=-1)
    p.add_argument("--ampdtype", type=str, default="")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--bias_init", type=str, default="", choices=("", "torch", "zeros"),
                   help="Bias init family: 'torch' (default) or 'zeros'")
    p.add_argument("--max_steps_per_epoch", type=int, default=0,
                   help="Debug: cap steps per epoch")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="Where to run: the GPU (NCCL between processes) or the CPU (gloo)")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), stage the dataset
    (``--stage_data``), then benchmark (``--benchmark N``: returns the six
    FPS metrics), or train and/or evaluate (returns ``train_and_eval``'s
    results, empty without --train or --eval)."""
    logging.basicConfig(format="[%(asctime)s] %(levelname)s: %(message)s",
                        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from rgbnomore_tpu_torch import parallel

    if args.coordinator or "WORLD_SIZE" in os.environ:
        parallel.init_distributed(
            args.coordinator or None,
            num_processes=args.num_processes if args.num_processes >= 0 else None,
            process_id=args.process_id if args.process_id >= 0 else None, device=args.device)
    try:
        return _run(args)
    finally:
        if parallel.is_initialized():
            torch.distributed.destroy_process_group()


def _run(args: argparse.Namespace) -> dict:
    """The body of ``main`` inside the process group (if any)."""
    import torch

    from rgbnomore_tpu_torch import parallel
    from rgbnomore_tpu_torch.train.config import configure_determinism, generate_config
    from rgbnomore_tpu_torch.train.loop import train_and_eval

    if args.num_devices >= 0 and args.num_devices != parallel.world_size():
        raise ValueError(f"--num_devices {args.num_devices}: the run has "
                         f"{parallel.world_size()} process(es), one per GPU; start N with "
                         "torchrun --nproc_per_node N or --coordinator")
    device = args.device
    if device == "cuda" and parallel.is_initialized():
        device = f"cuda:{torch.cuda.current_device()}"

    cfg = generate_config(
        modelarch=args.model_arch.lower(),
        domain=args.domain,
        modelver=args.embed_type,
        subblock=not args.no_subblock,
        epochs=None if args.epochs < 0 else args.epochs,
        batchsize=None if args.batch < 0 else args.batch,
        lr=None if args.lr < 0 else args.lr,
        wd=None if args.wd < 0 else args.wd,
        drop=None if args.drop < 0 else args.drop,
        warmup_steps=None if args.warmup_steps < 0 else args.warmup_steps,
        auglist=None if args.ops_list == "" else args.ops_list,
        num_ops=None if args.num_ops < 0 else args.num_ops,
        ops_magnitude=None if args.ops_magnitude < 0 else args.ops_magnitude,
        seed=None if args.seed < 0 else args.seed,
        amp=None if args.amp < 0 else bool(args.amp),
        ampdtype=None if args.ampdtype == "" else args.ampdtype,
        deterministic=args.deterministic or None,
    )
    if args.bias_init:
        cfg.model.bias_init = args.bias_init
    configure_determinism(cfg)
    if args.stage_data:
        from rgbnomore_tpu_torch.data.staging import stage_dataset

        stage_dataset(args.datapath, args.temp_datapath, no_extract=args.no_extract,
                      no_resize=args.no_resize, use_msrsync=args.use_msrsync,
                      workers=args.num_cpus)
    index_train, index_val = args.indexpaths.split(",")
    transfer = args.transfer or "cropped"

    if args.benchmark > 0:
        from rgbnomore_tpu_torch.benchmark import benchmark_model

        return benchmark_model(cfg, args.benchmark, index_train, index_val,
                               num_threads=args.num_cpus, verbose=args.verbose,
                               transfer=transfer, device=device)

    results: dict = {}
    if args.train or args.eval:
        results = train_and_eval(
            cfg, index_train, index_val,
            savepath=args.savepath,
            loadpath=args.loadpath,
            load_ckpt_dir=args.load_ckpt,
            run_train=args.train,
            run_eval=args.eval,
            verbose=args.verbose,
            num_threads=args.num_cpus,
            max_steps_per_epoch=args.max_steps_per_epoch or None,
            packed_k=args.packed_k or None,
            packed_k_eval=args.packed_k_eval or None,
            eval_fmt=args.eval_fmt or None,
            train_fmt=args.train_fmt or None,
            ckpt_every=args.ckpt_every,
            device=device,
            transfer=transfer,
        )
    if args.delete_dataset and parallel.is_rank0():
        import shutil

        shutil.rmtree(args.temp_datapath, ignore_errors=True)
    return results


if __name__ == "__main__":
    import json

    # the results as the last line, for scripts
    print(json.dumps(main()))

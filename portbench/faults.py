"""Faults that the check has to catch, planted in the program under a
cell's timed path (the tests and the calibration run them; the benchmark's
own runs never do).  Each takes the Trainer after set-up has built it.

- ``frozen``: a step that returns its state unchanged (no update).
- ``half_batch``: half of every batch left out, the mean over the rest.
- ``wrong_label``: one answer altered where it is produced: the first row's
  label out of the input stage.
- ``miscount``: an eval batch's top-1 tally off by one.
- ``no_exchange``: the gradient all-reduce between the ranks left out.
"""

from __future__ import annotations

import dataclasses

__all__ = ["FAULTS"]


def frozen(trainer) -> None:
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer) -> None:
    train_step, eval_step = trainer.train_step, trainer.eval_step

    def half_train(packed, draws):
        n = packed.shape[0] // 2
        keep = None if draws.drop_keep is None else draws.drop_keep[..., :n]
        return train_step(packed[:n], dataclasses.replace(
            draws, flip=draws.flip[:n], policy=tuple(p[:n] for p in draws.policy),
            drop_keep=keep))

    trainer.train_step = half_train
    trainer.eval_step = lambda packed: eval_step(packed[:packed.shape[0] // 2])


class _RelabelFirst:
    """An input pipeline whose first row's label is moved to the next class."""

    def __init__(self, pipe, classes: int):
        self.pipe, self.classes = pipe, classes

    def __call__(self, *args, **kwargs):
        *planes, labels, weights = self.pipe(*args, **kwargs)
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % self.classes
        return (*planes, labels, weights)

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def wrong_label(trainer) -> None:
    classes = trainer.cfg.model.classes
    trainer.train_pipe = _RelabelFirst(trainer.train_pipe, classes)
    trainer.eval_pipe = _RelabelFirst(trainer.eval_pipe, classes)


def miscount(trainer) -> None:
    eval_step = trainer.eval_step

    def counted(packed):
        sums = dict(eval_step(packed))
        sums["correct"] = sums["correct"] + 1
        return sums

    trainer.eval_step = counted


def no_exchange(trainer) -> None:
    trainer._sync_grads = lambda: None


FAULTS = {f.__name__: f for f in (frozen, half_batch, wrong_label, miscount, no_exchange)}

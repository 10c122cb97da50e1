"""Support shared by the port's tests (``tests/test_torch_port_*.py``)."""

import inspect
import sys


def settle_inspect_module_walk() -> None:
    """Take this process's first walk of ``inspect.getmodule`` over
    ``sys.modules`` now, where its fault is harmless.

    ``tests/test_torch_import.py`` installs a torchvision stub whose module
    ``__getattr__`` answers ``__file__`` with a function.  The first walk in
    a process that meets it raises ``AttributeError``; inspect has cached
    the stub's entry by then, so every later walk skips it.  torch walks
    when it first imports ``torch._dynamo``, which the first
    ``torch.optim`` optimizer in the process does.  Call this before a test
    builds one, so that the outcome does not hang on which test files ran
    earlier in the same process.
    """
    try:
        inspect.getmodule(sys._getframe(), "<settle>")
    except AttributeError:
        pass

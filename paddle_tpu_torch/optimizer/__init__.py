"""Optimizers of the port (the functional AdamW path of the trainer) and
its learning-rate schedulers."""
from . import lr  # noqa: F401
from .lr import LRScheduler  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

"""Optimizers of the port (the functional AdamW path of the trainer)."""
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

"""Neural-network helpers of the port (gradient clipping)."""
from .clip import ClipGradByGlobalNorm  # noqa: F401

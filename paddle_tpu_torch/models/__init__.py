"""Llama family: dense forward and loss, KV-cache decode, the paged/ragged
burst, and the training step."""
from .llama import LlamaConfig, llama_forward, llama_loss  # noqa: F401
from .trainer import LlamaTrainStep  # noqa: F401

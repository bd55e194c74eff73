"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one H100.

The package mirrors ``paddle_tpu``'s module layout (``models/llama.py``,
``models/llama_decode.py``, ``models/llama_paged.py``,
``models/trainer.py``, ``ops/ragged_attention.py``,
``ops/flash_attention.py``, ``ops/block_sparse_attention.py``,
``optimizer/``, ``nn/clip.py``, ``inference/paging.py``,
``inference/serving.py``, ``sparse/``) so each port sits beside its
counterpart's path.
It imports ``torch`` and never ``jax`` or ``paddle_tpu``; only the parity
tests import both packages.

Importing the package sets no global state (there is no counterpart of
``jax_enable_x64``: block tables and lengths are int32). Every entry point
runs on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

"""Quantization: the block codecs (``codec``) behind the int8 and fp8 KV
pages of the serving pool."""

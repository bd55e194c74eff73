"""Llama family: dense forward, KV-cache decode and the paged/ragged burst."""

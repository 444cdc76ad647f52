"""Batched multi-stream serving (PyTorch port)."""

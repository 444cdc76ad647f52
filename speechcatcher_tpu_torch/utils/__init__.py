"""Model packaging helpers (PyTorch port)."""

"""The benchmark of speechcatcher_tpu_torch (see benchmark/README.md)."""

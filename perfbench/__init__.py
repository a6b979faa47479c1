"""The benchmark of roc_tpu_torch on one H100 (see README.md)."""

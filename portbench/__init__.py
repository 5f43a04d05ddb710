"""portbench: the benchmark of malio_tpu_torch (see README.md)."""

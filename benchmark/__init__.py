"""The benchmark of the PyTorch and CUDA port, primia_tpu_torch (see PERF.md)."""

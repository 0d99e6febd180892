"""The benchmark of libde265_tpu_torch, the PyTorch and CUDA port: see
benchmark/README.md and BENCHMARK.json at the root of the checkout."""

"""The benchmark of terra_tpu_torch, the PyTorch and CUDA port: one cell a
run (``python3 -m benchmark.run``), driven by the data files beside this
one. It imports neither JAX nor the JAX package."""

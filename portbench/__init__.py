"""The benchmark of the PyTorch and CUDA port, jepsen_tpu_torch: see
run.py. It imports nothing of the JAX package and reads nothing of the
repo outside this folder but BENCHMARK.json and the port it measures."""

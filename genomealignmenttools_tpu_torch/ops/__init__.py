"""Device ops of the port: PyTorch around hand-written CUDA kernels
(counterpart of genomealignmenttools_tpu/ops/)."""

"""Engine entry points of the port: the reference engines whose aligner the
port must build itself (counterpart of genomealignmenttools_tpu/engines/)."""

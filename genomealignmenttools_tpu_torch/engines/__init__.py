"""Tool engines of the port: the port's own copies of the reference's
engines (counterpart of genomealignmenttools_tpu/engines/), scoring with
the torch scorer and aligning gaps with the port's band batch."""

"""Distribution layer of the port: device lists, sharded rescoring, merges.

Counterpart of genomealignmenttools_tpu/parallel/.  A "mesh" is a tuple of
torch.devices (mesh.make_mesh); work units are split into contiguous shards,
one per entry, each scored on its own device, and the results are put back
in input order, so every output byte is independent of the shard count.
Separate processes meet through torch.distributed (distributed.py).
"""

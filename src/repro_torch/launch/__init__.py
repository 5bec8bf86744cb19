"""Command-line entry points of the port: ``python -m
repro_torch.launch.train`` (coded training, on one process or, with
``--nproc``, on ranks that ``repro_torch.launch.ranks`` starts).  The
reference's mesh, shape, lowering and dry-run helpers describe
multi-device TPU meshes and have no counterpart on one card with a model
axis of 1."""

"""Scale-out over a ``('data', 'model')`` mesh of ``torch.distributed``
ranks: ``mesh`` (the mesh and its collectives) and ``tp`` (tensor-parallel
parameter shards). The submodules are imported by name, as ``models.layers``
imports ``mesh`` and ``tp`` imports the models."""

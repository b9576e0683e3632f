"""The sharding layer: logical-axis specs (``shard.P``), their placements
on a ``DeviceMesh`` (``shard``), and the tensor-parallel / FSDP rules of
every parameter (``partition``)."""

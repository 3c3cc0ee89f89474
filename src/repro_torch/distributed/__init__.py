"""Scale-out for the port: entity partitioning of the sharded BAD engine
(``partition``), the cross-shard notify shuffle and the sequence-parallel
decode (``collectives``).

One process drives every shard's device, as the reference's single-controller
engine does; no ``torch.distributed`` process group is involved."""

"""Distributed support of the port: the single-process training fault
tolerance (checkpoint/restart supervision, straggler watchdog), logical
spec resolution (``sharding``), tensor-parallel serving over
``torch.distributed`` (``tp``), training state sharded over the data
group (``fsdp``) and the prefix-affinity router over engine replicas
(``router``)."""

"""Parallel training: the sharding rules (``sharding``), the collectives
and their recorder (``collectives``) and the data-parallel train step
(``data_parallel``) -- the reference's ``repro/parallel`` on
``torch.distributed``."""

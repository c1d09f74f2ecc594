"""Shard and process workers of the port's runtime: the counterparts of
``repro.distributed.morsel_shards`` and ``repro.distributed.process_workers``,
which ``core.runtime.ExecutionContext.make_dispatcher`` imports for
``shards > 1`` and ``procs >= 1``."""

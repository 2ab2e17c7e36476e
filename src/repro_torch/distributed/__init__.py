"""The distributed learner plane (port of ``repro/distributed``): the
gradient-sync context (``grad_sync``), the data-parallel learner over D
lockstep shards (``learner``) and the sharded replay
(``replay_sharded``).

The reference's learner is one controller driving a device mesh through
``shard_map``. The port keeps one controller: the D shards of a step run in
threads of one process, each on its mesh device, and every collective of
the reference (``pmean``, ``psum``) is a barrier-synchronised reduction in
that process, taken in shard order (``learner.ShardGroup``). There are no
process groups and no ranks. Not ported yet (ROADMAP.md item 10d and
10e): FSDP (``sharding.py`` and ``grad_sync``'s FSDP parts), learner pods,
the sharded collection backend, the overlap schedule over a learner mesh,
``context.py`` and ``collectives.py``.
"""

"""The distributed learner plane (port of ``repro/distributed``): the
sharding rules (``sharding``), the gradient-sync context with FSDP
(``grad_sync``), the data-parallel learner over D lockstep shards with
FSDP and learner pods (``learner``) and the sharded replay
(``replay_sharded``).

The reference's learner is one controller driving a device mesh through
``shard_map``. The port keeps one controller: the D shards of a step run in
threads of one process, each on its mesh device, and every collective of
the reference (``pmean``, ``psum``, FSDP's all-gather and reduce-scatter)
is a barrier-synchronised exchange in that process, taken in shard order
(``grad_sync.ShardGroup``). There are no process groups and no ranks. Not
ported yet: D > 1 under the fused runtime (ROADMAP.md item 10f),
``context.py`` and ``collectives.py`` (item 10e).
"""

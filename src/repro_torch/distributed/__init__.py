"""Placement and training's distributed-optimization pieces: the Peregrine
path's device mesh (``sharding``: ``flow_mesh``, the ``flow_shards`` and
``tenants`` rules, ``ShardContext``), the remat policy context and int8
error-feedback gradient compression.  The LM stack's mesh half of the JAX
package's ``distributed/`` is not ported (ROADMAP queue 1 item 12g)."""

"""Placement and training's distributed-optimization pieces: the device
mesh (``sharding``: ``flow_mesh`` and the ``flow_shards`` and ``tenants``
rules of the Peregrine path; the LM stack's specs, ``NamedSharding`` and
``Placed`` blocks), ``mesh_rules.make_rules``, the parameter, optimizer
(ZeRO-1), batch and cache specs (``params``), sequence-parallel decode
(``seq_parallel``), the run-time flags (``flags``: local MoE dispatch), the
remat policy context and int8 error-feedback gradient compression."""

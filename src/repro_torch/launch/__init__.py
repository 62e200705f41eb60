"""Entry points of the port: ``serve`` and ``train`` (the launchers),
``mesh`` (the card's constants) and ``roofline``.

Modules of ``repro.launch`` (and the rest of the JAX package) with no torch
counterpart on one card, each because it reads what only XLA produces:

- ``launch/dryrun.py``: lowers and compiles every (arch x shape x mesh)
  cell against a 256- or 512-chip mesh and records XLA's
  ``memory_analysis``, ``cost_analysis`` and partitioned-HLO collectives;
  torch compiles no whole-step module whose cost it could report.
- ``launch/specs.py``: ``ShapeDtypeStruct`` stand-ins carrying
  ``NamedSharding``s for that dry-run; the port has no sharded abstract
  values.
- ``launch/regen_roofline.py``: recomputes the roofline of saved dry-run
  records; there are no such records here.
- ``compat.py``: shims over jax versions (``shard_map``, ``make_mesh``,
  ``AxisType``, ``set_mesh``); the port imports no jax.
- ``roofline.collective_bytes_from_hlo``: parses the SPMD-partitioned HLO
  text; torch produces none (``roofline.roofline_terms`` takes counted
  collective bytes instead).
- ``mesh.make_production_mesh`` (and ``make_bench_mesh``): device meshes;
  the one card's world is ``distributed.sharding.make_dist_ctx``.
"""

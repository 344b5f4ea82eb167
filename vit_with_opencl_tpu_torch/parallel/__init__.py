"""Multi-device execution: the JAX package's ``parallel/``.

``mesh`` (a device mesh driven by one process), ``collectives`` (JAX's
all_gather, ppermute, psum and psum_scatter over a mesh axis's shards) and
``spmd`` (data, tensor, sequence and sequence x tensor parallel inference;
the single-device training step). Training on a mesh, ``multihost``,
``pipeline`` and ``split_step`` are not ported yet."""

"""Training steps: the single-device part of the JAX package's
``parallel/`` (``spmd.make_train_step``); meshes are not ported yet."""

"""The port's record-producing scripts: counterparts of the repository's
``scripts/`` with the same names, arguments and printed lines.

Each runs as ``python -m vit_with_opencl_tpu_torch.scripts.<name> [args]``
and has a ``main(argv=None, device=None)`` that runs on the card unless the
caller passes ``device="cpu"`` (the plain PyTorch versions, as the tests
run them); without a card it raises. An option whose module the port does
not have yet raises ``NotImplementedError`` naming that module.
"""

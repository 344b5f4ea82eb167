"""Native runtime layer: C++ IO library with ctypes bindings.

Counterpart of ``vit_with_opencl_tpu/runtime``. Builds ``libvitio`` from
``vitio.cpp`` at first use (g++, -O3, into ``_build/`` by an atomic rename)
and exposes the loaders and the comparator with the same semantics as the
pure-NumPy io layer. ``io.binfmt`` remains the portable fallback; this is
the CLI's default data path (the role the reference's C host IO plays —
Network.c, dirent.c, Main.c's emitter, comparator.c). Host IO, not a kernel:
nothing here touches the card.
"""

from .native import (  # noqa: F401
    NativeIO,
    get_native_io,
    native_available,
)

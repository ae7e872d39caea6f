"""One-process stand-in for ``polychordlite_tpu/parallel/distributed.py``.

The port runs as a single process on one device.  Several processes over
``torch.distributed`` are not ported yet; until then process 0 is the only
process, owns every file product, and broadcasts are the identity.
"""

from __future__ import annotations


def is_root() -> bool:
    """True on the process that owns file output (always, in one process)."""
    return True


def broadcast_from_root(arr):
    """Adopt process 0's value on every process: the identity here."""
    return arr

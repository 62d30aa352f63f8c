"""Determinant ops layer: packed bitstrings, Slater-Condon kernels."""

from .bits import pack_np, unpack_np, keys_np, from_keys_np
from .excitations import build_excitation_spec, connection_count
from .slater import (SlaterTables, build_tables, diagonal_batch,
                     diagonal_batch_np, make_connection_fn,
                     make_connection_fn_auto, connection_kernel_choice,
                     connections_batch_np)

__all__ = [
    "pack_np", "unpack_np", "keys_np", "from_keys_np",
    "build_excitation_spec", "connection_count",
    "SlaterTables", "build_tables", "diagonal_batch", "diagonal_batch_np",
    "make_connection_fn", "make_connection_fn_auto",
    "connection_kernel_choice", "connections_batch_np",
]

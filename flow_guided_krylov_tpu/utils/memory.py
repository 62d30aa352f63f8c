"""Device-memory-aware sizing of device-resident structures.

Counterpart of the reference's GPU-memory-aware chunk/cache sizing
(``/root/reference/src/utils/system_scaler.py:399-437``): instead of
``torch.cuda.get_device_properties`` the budget comes from the JAX
device's ``memory_stats()['bytes_limit']``, which on a GPU already
reflects XLA's preallocated share of the card; the CPU backend falls back
to a host-RAM fraction.

Budgets are deliberately conservative fractions — XLA needs headroom for
fusion temporaries, the compiled-program heap, and the doubled buffers a
donated-input update keeps alive.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

__all__ = ["device_memory_bytes", "MemoryBudget"]


def device_memory_bytes(device=None) -> int:
    """Usable accelerator memory in bytes for the sizing heuristics.

    An accelerator that reports no ``bytes_limit`` raises: its size is
    not guessed."""
    import jax
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() if device.platform != "cpu" else None
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if device.platform != "cpu":
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit in memory_stats(); its memory size is unknown")
    # CPU backend: half the host RAM
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return int(pages * page_size * 0.5)
    except (ValueError, OSError):
        return 8 << 30


@dataclass(frozen=True)
class MemoryBudget:
    """Derives capacity knobs from the device memory size."""

    total_bytes: int

    @classmethod
    def for_device(cls, device=None) -> "MemoryBudget":
        return cls(device_memory_bytes(device))

    def connection_table_entries(self) -> int:
        """Cap for the precomputed all-connections table
        (``utils/connection_table.py``): each entry holds an int32 target
        index + a float32 element (8 B), and densification transiently
        doubles it.  Budget: 25% of memory."""
        return int(max(1_000_000, min(2_000_000_000,
                                      self.total_bytes * 0.25 / 16)))

    def nqs_chunk_size(self, n_inputs: int,
                       hidden_dims: Optional[Sequence[int]] = None) -> int:
        """Chunk length for gradient-free NQS evaluation over connection
        batches: a chunk keeps (inputs + activations) f32 live per row.
        Budget: 10% of memory; clamped to [4096, 131072] and rounded to a
        multiple of 1024 so few chunk shapes (and compiles) occur."""
        width = n_inputs + sum(hidden_dims or [256] * 4)
        rows = self.total_bytes * 0.10 / (4 * max(width, 1))
        rows = max(4096, min(131072, int(rows)))
        return (rows // 1024) * 1024

    def dense_hamiltonian_cap(self, n_copies: int = 2) -> int:
        """Max subspace dimension whose dense f32 H (plus ``n_copies``-1
        working copies inside the Lanczos matvec pipeline) fits in 25% of
        memory: dim^2 * 4 * n_copies <= 0.25 * total."""
        dim = (self.total_bytes * 0.25 / (4 * max(n_copies, 1))) ** 0.5
        return int(max(4096, min(65536, dim)))

    def lanczos_ell_m(self, n_states: int, n_connections: int,
                      m_max: int = 120) -> int:
        """Max Lanczos depth for the fully-reorthogonalized device ELL
        eigensolver (``postprocessing/eigensolver.py``): the (m+1, N)
        Krylov block is the dominant allocation next to the two (C, N)
        tables (f32 + s32) and a few N-vector temporaries.  Budget the
        block at 40% of memory minus the tables; depth beyond what fits
        comes from restarts (``lanczos_ground_state_ell(...,
        restarts=...)``)."""
        tables = 2 * n_connections * n_states * 4
        scratch = 8 * n_states * 4
        block = self.total_bytes * 0.40 - tables - scratch
        m = int(block / (max(n_states, 1) * 4)) - 1
        return max(4, min(m_max, m))

    def pt2_score_rows(self, n_connections: int) -> int:
        """Max source rows per PT2 device-scoring call
        (``krylov/residual_expansion.py``): the call flattens
        rows * n_connections candidates and sorts (key, contrib) pairs —
        the connection arrays (~12 B/entry), the sort operands and their
        temporaries (~24 B), and the segment-sum/score vectors (~12 B)
        put the live footprint near 48 B/entry.  Budget: 40% of memory,
        rounded down to a power of two so the block shape (and compiled
        program) is stable across rounds."""
        entries = self.total_bytes * 0.40 / 48
        rows = int(max(64, entries / max(n_connections, 1)))
        return 1 << (rows.bit_length() - 1)

    def statevector_sites_cap(self) -> int:
        """Max spin count for the full-2^n statevector Trotter propagator:
        each substep keeps ~4 live (re, im) f32 vector pairs, so
        2^n * 8 * 4 <= 50% of memory."""
        import math
        n = math.log2(max(self.total_bytes * 0.50 / 32, 2))
        return int(max(16, min(28, n)))

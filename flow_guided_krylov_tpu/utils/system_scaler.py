"""Formula-based automatic pipeline sizing.

Counterpart of ``/root/reference/src/utils/system_scaler.py``: a second,
formula-driven auto-configuration mechanism (complementing the tier-based
``PipelineConfig.adapt_to_system_size``): size tiers, FAST/BALANCED/
ACCURATE quality presets, scaling laws for network width / samples /
epochs / Krylov dimension, and a runtime adjuster
(``system_scaler.py:39-636``).

Scaling laws (``system_scaler.py:274-344``):
    hidden_dim  ~ 16 * log2(n_configs)
    samples     ~ 32 * sqrt(n_configs)
    epochs      ~ 200 * log10(n_configs)
    krylov_dim  ~ log2(n_configs) / 2
    time_step   = pi / (2 * krylov_dim)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Dict

__all__ = ["SystemTier", "QualityPreset", "SystemScaler",
           "AdaptiveAdjuster", "create_pipeline_config",
           "auto_scale_pipeline"]


class SystemTier(Enum):
    TINY = "tiny"          # <= 100 configs
    SMALL = "small"        # <= 1k
    MEDIUM = "medium"      # <= 10k
    LARGE = "large"        # <= 100k
    HUGE = "huge"          # > 100k

    @classmethod
    def for_size(cls, n_configs: int) -> "SystemTier":
        if n_configs <= 100:
            return cls.TINY
        if n_configs <= 1_000:
            return cls.SMALL
        if n_configs <= 10_000:
            return cls.MEDIUM
        if n_configs <= 100_000:
            return cls.LARGE
        return cls.HUGE


class QualityPreset(Enum):
    FAST = "fast"
    BALANCED = "balanced"
    ACCURATE = "accurate"

    @property
    def multipliers(self) -> Dict[str, float]:
        return {
            QualityPreset.FAST: {"epochs": 0.5, "samples": 0.5,
                                 "basis": 0.5, "krylov": 0.75},
            QualityPreset.BALANCED: {"epochs": 1.0, "samples": 1.0,
                                     "basis": 1.0, "krylov": 1.0},
            QualityPreset.ACCURATE: {"epochs": 2.0, "samples": 1.5,
                                     "basis": 1.5, "krylov": 1.25},
        }[self]


@dataclass
class SystemScaler:
    """Compute scaled hyperparameters for a configuration-space size."""

    n_configs: int
    preset: QualityPreset = QualityPreset.BALANCED

    @property
    def tier(self) -> SystemTier:
        return SystemTier.for_size(self.n_configs)

    def scaled_parameters(self) -> Dict[str, float]:
        n = max(self.n_configs, 2)
        m = self.preset.multipliers
        log2n = math.log2(n)
        hidden = int(min(768, max(64, 16 * log2n)))
        samples = int(min(8192, max(256, 32 * math.sqrt(n) * m["samples"])))
        epochs = int(min(1200, max(100, 200 * math.log10(n) * m["epochs"])))
        krylov = int(min(16, max(3, round(log2n / 2 * m["krylov"]))))
        basis_cap = int(min(n, max(512, 4 * math.sqrt(n) * 32 * m["basis"])))
        n_layers = 3 if n <= 1_000 else (4 if n <= 10_000 else 5)
        return {
            "nqs_hidden_dim": hidden,
            "nqs_layers": n_layers,
            "nf_hidden_dim": max(64, hidden // 2),
            "samples_per_batch": samples,
            "max_epochs": epochs,
            "min_epochs": max(50, epochs // 4),
            "max_krylov_dim": krylov,
            "time_step": math.pi / (2 * krylov),
            "max_accumulated_basis": basis_cap,
            "max_diverse_configs": max(256, basis_cap // 2),
            "residual_iterations": int(min(20, max(5, log2n))),
            "residual_configs_per_iter": int(min(500, max(50,
                                                          math.sqrt(n) * 4))),
            # SHCI-style proportional stage-3 adds on big spaces: the same
            # accuracy at a fraction of the wall on the 2.7M-state
            # Heisenberg-24 deep run; small spaces keep the reference's
            # fixed schedule
            "residual_growth_factor": 0.15 if n > 200_000 else 0.0,
            "shots_per_krylov": int(min(200_000, max(10_000, n * 10))),
        }

    def memory_parameters(self, n_sites: int,
                          hidden_dims=None) -> Dict[str, int]:
        """Device-memory-aware capacity knobs (reference GPU-memory chunk/
        cache sizing, ``system_scaler.py:399-437``; here derived from the
        JAX device's memory_stats — see ``utils/memory.py``).  These feed
        ``PhysicsGuidedConfig`` / SKQD, which the pipeline wires
        automatically; exposed here for parity and for direct trainer
        construction."""
        from .memory import MemoryBudget
        mem = MemoryBudget.for_device()
        return {
            "nqs_chunk_size": mem.nqs_chunk_size(n_sites, hidden_dims),
            "connection_table_max_entries": mem.connection_table_entries(),
            "dense_local_energy_max_dim": mem.dense_hamiltonian_cap(),
            "statevector_sites_cap": mem.statevector_sites_cap(),
        }

    def create_pipeline_config(self, **overrides):
        """Build a PipelineConfig from the scaling laws
        (``system_scaler.py:439-485``)."""
        from ..pipeline import PipelineConfig
        p = self.scaled_parameters()
        cfg = PipelineConfig(
            nqs_hidden_dims=[p["nqs_hidden_dim"]] * p["nqs_layers"],
            nf_hidden_dims=[p["nf_hidden_dim"]] * 2,
            samples_per_batch=p["samples_per_batch"],
            max_epochs=p["max_epochs"],
            min_epochs=p["min_epochs"],
            max_krylov_dim=p["max_krylov_dim"],
            time_step=p["time_step"],
            max_accumulated_basis=p["max_accumulated_basis"],
            max_diverse_configs=p["max_diverse_configs"],
            residual_iterations=p["residual_iterations"],
            residual_configs_per_iter=p["residual_configs_per_iter"],
            residual_growth_factor=p["residual_growth_factor"],
            shots_per_krylov=p["shots_per_krylov"],
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


class AdaptiveAdjuster:
    """Runtime heuristics (``system_scaler.py:537-609``): widen sampling if
    the flow collapses too early, extend training if energy is still
    falling."""

    def __init__(self, patience: int = 20):
        self.patience = patience

    def suggest(self, history: Dict[str, list]) -> Dict[str, str]:
        tips: Dict[str, str] = {}
        ur = history.get("unique_ratios", [])
        en = history.get("energies", [])
        if len(ur) >= self.patience:
            if ur[-1] > 0.9:
                tips["samples_per_batch"] = (
                    "increase: flow still produces >90% unique samples")
            if ur[-1] < 0.02 and len(ur) < 100:
                tips["convergence_threshold"] = (
                    "flow collapsed very early; consider higher entropy "
                    "weight or temperature")
        if len(en) >= 2 * self.patience:
            recent = en[-self.patience:]
            earlier = en[-2 * self.patience:-self.patience]
            if (sum(earlier) / len(earlier)
                    - sum(recent) / len(recent)) > 1e-4:
                tips["max_epochs"] = "increase: energy still improving"
        return tips


def create_pipeline_config(n_configs: int,
                           preset: QualityPreset = QualityPreset.BALANCED,
                           **overrides):
    return SystemScaler(n_configs, preset).create_pipeline_config(**overrides)


def auto_scale_pipeline(hamiltonian,
                        preset: QualityPreset = QualityPreset.BALANCED,
                        **overrides):
    """Hamiltonian -> scaled PipelineConfig (``system_scaler.py:612-636``)."""
    n = getattr(hamiltonian, "n_valid_configs", None)
    if n is None:
        n = 1 << hamiltonian.n_sites
    return create_pipeline_config(n, preset, **overrides)

"""flow_guided_krylov_tpu — flow-guided Krylov diagonalization in JAX.

A JAX/XLA rebuild of the Flow-Guided-Krylov hybrid quantum-classical
pipeline: particle-conserving normalizing flows co-trained with neural
quantum states discover the support of molecular ground-state
wavefunctions; the basis is diversity-selected, expanded Selected-CI-style
with PT2 importance, and refined with sample-based Krylov quantum
diagonalization.  Device work runs on one GPU or a mesh of them.

Public entry point mirrors the reference (``src/__init__.py:19-24``).
"""

__version__ = "0.1.0"

__all__ = ["FlowGuidedKrylovPipeline", "PipelineConfig"]


def __getattr__(name):
    # Lazy import: keep `import flow_guided_krylov_tpu` light (no jax init)
    if name in ("FlowGuidedKrylovPipeline", "PipelineConfig",
                "run_molecular_benchmark"):
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)

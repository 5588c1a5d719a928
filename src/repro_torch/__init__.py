"""PyTorch / CUDA port of ``repro`` for the NVIDIA H100.

A package of its own beside ``src/repro/`` (the JAX reference): it imports
``torch`` and numpy, never ``jax`` and never any module of ``repro``, and
mirrors the reference's layout (``core/``, ``kernels/<name>/``) so each
module's counterpart is easy to find.  Entry points take ``device``,
default ``"cuda"``; ``device="cpu"`` runs the kernels' plain PyTorch
versions, and asking for ``cuda`` without a card raises.  ``plan`` also
takes ``plan_backend`` ("pipeline", the default on a card, or "python",
the default on the CPU); every combination gives the same plan.

    from repro_torch.core import paper_workload, plan
    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=1.0)
    result = plan(inst, "gdm", seed=0)          # on the card, pipeline
    result.twct(); result.transcript()
"""

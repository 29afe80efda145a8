"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Each module sits at the same relative path as its ``repro`` counterpart.
The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.  Entry points run on the card (``device="cuda"``) and raise when
there is none, unless the caller asks for ``device="cpu"``.
"""

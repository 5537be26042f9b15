"""PyTorch port of the Krites serving path for one NVIDIA H100.

A second package beside :mod:`repro` (the JAX reference). It keeps the
reference's module paths and public names so counterparts are easy to
find, imports ``torch`` and never ``jax`` or anything of ``repro``, and
runs on ``cuda`` unless a caller passes ``device="cpu"``.
"""

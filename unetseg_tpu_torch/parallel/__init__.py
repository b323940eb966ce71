"""Device meshes and the data-parallel split (``mesh``, ``batch``), the
multi-process setup (``distributed``), sliding windows at native resolution
(``tiles``) and the TTA ensemble (``tta``)."""

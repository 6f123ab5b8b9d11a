"""Protocol models ported from ``partisan_tpu/models``."""

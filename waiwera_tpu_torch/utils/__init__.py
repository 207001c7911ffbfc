"""Host-side utilities: tracked configuration reads and the YAML log
(counterpart of waiwera_tpu/utils)."""

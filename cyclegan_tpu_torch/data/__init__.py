"""Host-side data pipeline (numpy + PIL copies of the JAX package's
readers, transforms and palette; the loaders; the ctypes binding of the
native pixel library)."""

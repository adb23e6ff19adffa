"""Host-side utilities (the inference pipeline)."""

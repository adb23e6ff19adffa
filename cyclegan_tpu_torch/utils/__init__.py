"""Host-side utilities (the config and its presets, the inference
pipeline)."""

"""Host-side input pipelines (no device code)."""

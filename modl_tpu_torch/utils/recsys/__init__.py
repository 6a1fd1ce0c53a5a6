"""Recsys evaluation helpers (numpy only)."""

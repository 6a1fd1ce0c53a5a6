"""Patch extraction (host side)."""

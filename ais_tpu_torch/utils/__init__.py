"""Bit and CPM helpers (numpy)."""

"""Bit and CPM helpers (numpy); profiling helpers."""

"""Burst synchronization: detection, feedforward and PLL timing, MLSE."""

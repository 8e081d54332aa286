"""Burst synchronization: detection and feedforward timing."""

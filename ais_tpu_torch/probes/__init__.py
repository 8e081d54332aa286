"""Measurement scripts for the card; nothing here is on a receive path."""

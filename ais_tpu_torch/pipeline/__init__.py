"""Receivers: the burst demodulator, the wideband wire receiver, the host back half."""

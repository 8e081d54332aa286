"""Receivers: the burst demodulator, the wideband wire receiver, the host
back half, and the multi-process wire fan (`multiproc.py`: wire steps over
N processes on one card, to spread the host back half over cores)."""

"""Peaks of the card and the operations and bytes of the measured kernels."""

"""Kernels B3 (the whole-drain megakernel) and B4 (the row-slice stream)
and their plain versions; see each module."""

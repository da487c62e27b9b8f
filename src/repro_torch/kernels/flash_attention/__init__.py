"""Kernel B5, causal / sliding-window GQA flash attention, and its plain
version; see each module."""

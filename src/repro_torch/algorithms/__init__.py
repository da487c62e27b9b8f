"""Algorithms on the Atos scheduler: speculative and level-synchronous BFS."""

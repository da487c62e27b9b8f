"""The ordered scatter-add: PageRank's deterministic ``.at[].add``."""

"""LLM serving: the continuous-batching engine (counterpart of
``repro/serving``)."""

"""Language-model stack: parameter specs, layers, the dense transformer's
prefill and decode (counterparts of ``repro/models``)."""

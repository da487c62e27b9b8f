"""Language-model stack: parameter specs, layers, the MoE layer, the Mamba
block and the family-dispatched transformer's prefill and decode for every
family (counterparts of ``repro/models``)."""

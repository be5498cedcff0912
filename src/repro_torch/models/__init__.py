"""The LM stack of the port: configuration, parameter declarations, the
layers (attention, MLP, MoE, Mamba with the selective-scan kernel K8) and
the prefill / decode entry points behind :class:`api.Model`."""

"""LM model stack of the port (counterpart of ``repro.models``): the
hybrid Mamba2 + shared-attention family's serving path."""

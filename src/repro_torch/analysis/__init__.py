"""Static analysis of the int8 datapath (overflow certificates)."""

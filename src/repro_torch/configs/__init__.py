"""Port of ``repro.configs``: the synthetic SpMV test-matrix suite, the ten
LM architecture configs and their registry (``--arch <id>``)."""

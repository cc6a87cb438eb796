"""Port of ``repro.configs``: the synthetic SpMV test-matrix suite."""

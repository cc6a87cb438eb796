"""Port of the pieces of ``repro.optim`` that the sparse path uses."""

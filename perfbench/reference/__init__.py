"""The plain reference: a path tracer in plain PyTorch and NumPy with
the estimator's semantics (cameras, the unit-triangle intersection test,
the three samplers, Russian roulette, the regenerating lanes and their
random streams). It imports nothing of the program under test and takes
nothing the program made: it works from the benchmark's own scene arrays
and seeds."""

"""Integrator, regenerating wavefront, film and the progressive renderer."""

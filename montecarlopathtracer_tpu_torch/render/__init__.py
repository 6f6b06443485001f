"""Integrator, film and the progressive renderer."""

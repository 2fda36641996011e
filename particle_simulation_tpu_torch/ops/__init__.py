"""Particle, grid and population operations of the port."""

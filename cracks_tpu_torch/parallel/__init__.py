"""Sharded-DoF layout of the port: lattice-layout DoF vectors cut into D
row slabs along the leading grid axis (see `sharding`)."""

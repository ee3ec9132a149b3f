"""Sharded-DoF layouts of the port, D shards on one device: lattice-layout
DoF vectors cut into row slabs along the leading grid axis
(`sharding`), and the owned+ghost halo pool of general meshes (`halo`)."""

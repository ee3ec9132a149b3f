"""Sharded-DoF layouts of the port: lattice-layout DoF vectors cut into
row slabs along the leading grid axis (`sharding`), and the owned+ghost
halo pool of general meshes (`halo`), D shards on one device or, for
the halo pool, on W ranks of a process group (`dist`)."""

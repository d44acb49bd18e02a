"""Scale-out over several devices: the mesh, distributed Schur BA, sharded
matching and sharded stereo."""

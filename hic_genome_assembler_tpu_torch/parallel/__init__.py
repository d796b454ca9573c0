"""Device meshes, run bring-up and chromosome sharding across processes."""

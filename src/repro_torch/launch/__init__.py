"""Launch layer (port of ``repro.launch``): meshes, step builders, the
dry run and its cost analysis."""

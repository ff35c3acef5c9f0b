"""Command-line launchers of the port (``python -m repro_torch.launch.train``,
``.serve``) and the tools that describe a mesh: ``mesh`` (the production
meshes), ``dryrun`` (one step of a cell on DTensors over a fake process
group), ``op_cost`` (what one rank runs, counted) and ``roofline``."""

"""The launch layer: partition specs and mesh hints (``constraints``),
the production and host device meshes (``mesh``), the collectives a step
issues (``collective_stats``) and the dry run over every cell
(``python -m repro_torch.launch.dryrun``)."""

"""Launch entry points of the port: the serving entry point
(``python -m repro_torch.launch.serve``)."""

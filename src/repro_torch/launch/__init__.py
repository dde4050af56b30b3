"""Launch entry points of the port: serving (``python -m
repro_torch.launch.serve``) and training (``python -m
repro_torch.launch.train``), the step builders they share
(``launch/steps.py``) and device meshes (``launch/mesh.py``)."""

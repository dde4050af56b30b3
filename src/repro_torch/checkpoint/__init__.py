"""Checkpoints in the reference's format (``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            flatten_with_paths,
                                            unflatten_from_paths)

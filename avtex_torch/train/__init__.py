"""Training-side modules of the port. So far only the checkpoint files
(``checkpoint.py``); the training loop is ROADMAP.md Queue 1
'Training'."""

from .checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["restore_checkpoint", "save_checkpoint"]

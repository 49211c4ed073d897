"""Session checkpoints in the reference's msgpack layout
(`repro_torch.checkpointing.io`)."""
from repro_torch.checkpointing.io import (Fields, load_metadata, load_pytree,
                                          save_json, save_pytree)

__all__ = ["Fields", "load_metadata", "load_pytree", "save_json",
           "save_pytree"]

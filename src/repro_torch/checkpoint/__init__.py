"""Checkpoints in the reference's format: reading the reference's into the
port's modules, and writing the port's for either package to read."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, flatten_tree,
                                                 load_train_state,
                                                 save_pytree, train_tree)
from repro_torch.checkpoint.convert import (load_lm_train_state,
                                            load_reference_lm_params,
                                            load_reference_params,
                                            lm_train_tree,
                                            read_reference_checkpoint,
                                            split_prefix)

__all__ = ["Checkpointer", "save_pytree", "flatten_tree", "train_tree",
           "load_train_state", "read_reference_checkpoint",
           "load_reference_params", "load_reference_lm_params",
           "lm_train_tree", "load_lm_train_state", "split_prefix"]

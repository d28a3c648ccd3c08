"""Reading the reference's checkpoints into the port's modules."""
from repro_torch.checkpoint.convert import (load_reference_params,
                                            read_reference_checkpoint,
                                            split_prefix)

__all__ = ["read_reference_checkpoint", "load_reference_params",
           "split_prefix"]

"""Synthetic LM data (counterpart of ``repro.data``): the deterministic,
checkpointable Zipf token stream of LM pretraining and the input specs of
every (arch x shape) cell."""
from repro_torch.data.synthetic import (SyntheticTokens, input_specs,
                                        make_batch, make_decode_batch)

__all__ = ["SyntheticTokens", "input_specs", "make_batch",
           "make_decode_batch"]

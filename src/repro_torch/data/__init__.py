"""The seeded synthetic data pipeline: the port of ``repro.data``;
exports what the reference imports into its package."""
from repro_torch.data.pipeline import (DataConfig, data_iterator,
                                       make_data_config, synth_batch)

__all__ = ["DataConfig", "data_iterator", "make_data_config", "synth_batch"]

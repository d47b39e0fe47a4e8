from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, prefetch

__all__ = ["DataConfig", "SyntheticLMDataset", "prefetch"]

from .pipeline import Prefetcher, SyntheticLM, to_device

__all__ = ["Prefetcher", "SyntheticLM", "to_device"]

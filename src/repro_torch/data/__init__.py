from .pipeline import Prefetcher, SyntheticLM, make_global_batch, to_device

__all__ = ["Prefetcher", "SyntheticLM", "make_global_batch", "to_device"]

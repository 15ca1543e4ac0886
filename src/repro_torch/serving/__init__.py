from .kv_pool import PagedAllocator, PagedKVPool
from .engine import ServeEngine, Request

__all__ = ["PagedAllocator", "PagedKVPool", "ServeEngine", "Request"]

from .prefetch import Prefetcher

__all__ = ["Prefetcher"]

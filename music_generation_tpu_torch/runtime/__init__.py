from .indexed_dataset import IndexedDataset, IndexedDatasetBuilder
from .native_loader import maximum_path_native, native_available
from .prefetch import Prefetcher

__all__ = ["IndexedDataset", "IndexedDatasetBuilder", "Prefetcher",
           "maximum_path_native", "native_available"]

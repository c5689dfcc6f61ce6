from .monotonic_align import (mas_duration_targets, mas_neg_cent,
                              maximum_path, maximum_path_torch)

__all__ = ["maximum_path", "maximum_path_torch", "mas_neg_cent",
           "mas_duration_targets"]

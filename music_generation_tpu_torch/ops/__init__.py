from .monotonic_align import (MasPlan, mas_duration_targets, mas_neg_cent,
                              mas_plan, maximum_path, maximum_path_torch)

__all__ = ["maximum_path", "maximum_path_torch", "mas_neg_cent",
           "mas_duration_targets", "mas_plan", "MasPlan"]

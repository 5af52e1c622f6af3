from .fuse import (check_geometric_consistency, filter_depth_views,
                   fuse_scan, reproject_with_depth, DTU_IMG_DIST_THRESHOLDS)
from .dtu_eval import (dtu_point_compare, dtu_eval_scans, reduce_points,
                       DTU_EVAL_SETS)

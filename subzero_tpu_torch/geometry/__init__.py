from .polygon import (
    apply_padding,
    pad_polygon,
    pad_polygons,
    points_in_polygon,
    poly_angles,
    poly_area,
    poly_centroid,
    poly_edges,
    poly_inertia_z,
    poly_moments,
    poly_rmax,
)
from .clip import OverlapStats, difference_stats, intersection_area, overlap_stats
from .clip_batched import difference_stats_bm, overlap_stats_bm
from .clip_integral import difference_stats_int, overlap_stats_int
from .measures import cut_polygon, point_poly_dist, segment_intersections
from .regions import RegionStats, region_stats, reverse_polygons

__all__ = [
    "apply_padding",
    "pad_polygon",
    "pad_polygons",
    "points_in_polygon",
    "poly_angles",
    "poly_area",
    "poly_centroid",
    "poly_edges",
    "poly_inertia_z",
    "poly_moments",
    "poly_rmax",
    "OverlapStats",
    "difference_stats",
    "difference_stats_bm",
    "difference_stats_int",
    "overlap_stats_bm",
    "overlap_stats_int",
    "cut_polygon",
    "point_poly_dist",
    "segment_intersections",
    "intersection_area",
    "overlap_stats",
    "RegionStats",
    "region_stats",
    "reverse_polygons",
]

from .polygon import (
    pad_polygon,
    pad_polygons,
    points_in_polygon,
    poly_area,
    poly_centroid,
    poly_edges,
    poly_moments,
)
from .clip import OverlapStats
from .clip_integral import difference_stats_int, overlap_stats_int
from .regions import RegionStats, region_stats, reverse_polygons

__all__ = [
    "pad_polygon",
    "pad_polygons",
    "points_in_polygon",
    "poly_area",
    "poly_centroid",
    "poly_edges",
    "poly_moments",
    "OverlapStats",
    "difference_stats_int",
    "overlap_stats_int",
    "RegionStats",
    "region_stats",
    "reverse_polygons",
]

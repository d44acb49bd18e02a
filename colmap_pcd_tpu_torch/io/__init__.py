"""File formats: PLY point clouds."""

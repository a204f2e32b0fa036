"""Geometry: vectors, rays, camera tracks and the voxel volume."""

"""Scorer of the lidar outputs: FRD."""

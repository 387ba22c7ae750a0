"""The warp engine: transforms, grid maps, resample (K1) and the MOTA mask."""

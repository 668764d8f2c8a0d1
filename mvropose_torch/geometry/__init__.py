"""Geometry in plain torch. Ported so far: heatmap rendering and decoding."""

"""Scorers of the camera outputs: CLIP-FID (or Inception FID), LPIPS, CLIP score."""

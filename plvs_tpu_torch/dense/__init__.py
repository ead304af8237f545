"""Dense mapping: stereo depth (K3), depth filtering, TSDF fusion, meshing."""

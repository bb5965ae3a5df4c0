"""The render passes of the ported frame.

cull            object pre-cull, frustum/cone/Nanite-LOD/HZB cull, compaction
hzb             hierarchical-Z pyramid + occlusion tests
mesh_shader     draw expansion + triangle setup          (kernel K2)
raster          work-queue binning + tiled visibility raster (kernel K1)
row_gather      per-pixel rows of per-draw tables         (kernel K3)
shading         g-buffer resolve + GGX sun/ambient lighting
tile_reproject  per-tile history reprojection             (kernel K4)
post            auto-exposure, bloom, tile-mode TSR upscale
colorspace      ACEScg pipeline + ACES tonemap
"""

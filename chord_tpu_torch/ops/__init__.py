"""The render passes of the ported frame.

cull            object pre-cull, frustum/cone/Nanite-LOD/HZB cull, compaction
hzb             hierarchical-Z pyramid + occlusion tests
mesh_shader     draw expansion + triangle setup          (kernel K2)
raster          work-queue binning + tiled visibility raster (kernel K1)
row_gather      per-pixel rows of per-draw tables         (kernel K3)
shading         g-buffer resolve + GGX sun/ambient lighting
texture         mip pick, material-map sampling
paged_texture   paged, block-compressed texture sampler   (kernel K5)
shadow          cascade fits, PCSS prepass + plain PCSS
shadow_kernel   PCSS taps over the cascade stack           (kernel K6)
atmosphere      sky LUTs, sun disk, ambient, aerial perspective
sh              SH3 basis, projection, evaluation, packing
brdf_lut        split-sum env BRDF LUT + its analytic fit
gi              world SH cache (inject, propagate, sample), SSAO, RTAO
screen_probe    screen-probe GI stage (taps or the march) + the specular
                filter chain
ddgi            DDGI probe volumes: update over the BVH, sampling
ssr             screen-space reflection march
rt              scene BVH build (host; sphere or triangle leaves) +
                closest-hit rays and hit shading
tile_reproject  per-tile history reprojection             (kernel K4)
post            auto-exposure, bloom, tile-mode TSR upscale
colorspace      ACEScg pipeline + ACES tonemap
fusion_barrier  identity copy into a new tensor            (kernel K9)
proto_paged_tex palette sampler of the texture prototype   (kernel K10)
"""

"""Device ops and host planning for the compute path.

Modules:

* :mod:`.histogram`      — device value histogram + exact host entropy/MI
                           replay
* :mod:`.decompose`      — adaptive cut point (bit-identical to NumPy)
* :mod:`.segments`       — host segment distribution and plane plans
* :mod:`.blocks`         — device tile popcounts + exact host ranking
* :mod:`.embed`          — plain torch raster and block embed/extract +
                           XOR maps
* :mod:`.host_embed`     — numpy raster embed of the host route
* :mod:`.host_extract`   — numpy raster and block extraction
* :mod:`.raster_kernels` — CUDA kernels K1/K2, their wrappers and counts
* :mod:`.pee`            — plain torch PEE passes, histograms, both-pass
                           chains
* :mod:`.pee_kernels`    — CUDA kernels K3/K4, their wrappers and counts
* :mod:`.kernel_library` — builds and binds the kernels' one library
* :mod:`.metrics`        — fused quality reductions, the float64 host
                           report, windowed SSIM
* :mod:`.bitplanes`      — bit-plane split / merge
* :mod:`.callback_codec` — transport codecs as fixed-size byte-buffer
                           stages
"""

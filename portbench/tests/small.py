"""Each cell at a size a CPU test run holds: the same entry, configuration
and checks, on 64x64 images (a 2500-bit PEE payload, which needs both
passes; a 4-image batch; a 4-slice series at half its LSB capacity)."""

SMALL = {
    "mr512_hybrid.single": {"height": 64, "width": 64, "pool": 2,
                            "check_sample": 2},
    "cr2048_pee.single": {"height": 64, "width": 64, "pool": 2,
                          "check_sample": 2, "payload_bits": 2500},
    "mr512_hybrid.batch32": {"height": 64, "width": 64, "pool": 2,
                             "check_sample": 2, "batch": 4},
    "mr512_hybrid.volume64": {"height": 64, "width": 64, "pool": 1,
                              "check_sample": 1, "depth": 4,
                              "payload_bits": 3000},
}
